from tensortruth_tpu_torch.tokenization.tokenizer import (
    HFTokenizer,
    SimpleTokenizer,
    Tokenizer,
    load_tokenizer,
)

__all__ = ["Tokenizer", "SimpleTokenizer", "HFTokenizer", "load_tokenizer"]
