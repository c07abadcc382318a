"""Measurement scripts that run on the card (``python -m tensortruth_tpu_torch.scripts.<name>``)."""
