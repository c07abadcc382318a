"""Drive chip_smoke.py's main path alone, from the checkout given: that
checkout's own package, kernels and chip_smoke.py. Run as a file, so that
the checkout named comes first on the import path:

    python3 tensortruth_tpu_torch/scripts/main_path_ab.py ROOT LABEL   # needs one CUDA card

To compare two commits on one card, unpack the other commit (``git archive``)
into a git-ignored directory and run parent, change, change, parent one
after another on the same card; each run prints its request times and its profiled request.
Where the checkout's main path serves the ``docs`` index that ``build_db``
writes (its ``chip_smoke.py`` has ``lay_out``), that module is laid out and
built first, as ``chip_smoke.py``'s build path does; an older checkout's
main path builds its own.
"""

import importlib.util
import os
import shutil
import sys
import tempfile
from pathlib import Path


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    label = sys.argv[2] if len(sys.argv) > 2 else str(root)
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)

    import torch

    from tensortruth_tpu_torch import _build

    if not Path(_build.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"the package came from {_build.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=root))
    for var, sub in (("TENSOR_TRUTH_TPU_DATA_DIR", "data"), ("TENSOR_TRUTH_TPU_INDEXES_DIR", "indexes"),
                     ("TENSOR_TRUTH_TPU_NATIVE_CACHE", "native"), ("TENSOR_TRUTH_TPU_MODELS_DIR", "models"),
                     ("HF_HUB_CACHE", "hf")):
        os.environ[var] = str(work / sub)
    try:
        _build.load()
        print(f"=== main path of {label} ({root})", flush=True)
        if hasattr(smoke, "lay_out"):
            smoke.lay_out({"docs": smoke.docs_texts()})
            smoke.build(torch, "docs")
        smoke.run_main_path(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
