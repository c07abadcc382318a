"""Kernel B5 (``tc_matmul``, tensortruth_tpu_torch/ops/matmul.py) and its
probe against the reference's (scripts/probe_int8_mxu_pallas.py), on the CPU.

* ``tc_matmul`` on CPU tensors (the plain version, taken because the tensors
  lie on the CPU) against the reference's ``pallas_matmul`` in TPU interpret
  mode (``force_tpu_interpret_mode``) at M=256, K=128, N=256 with 128x128
  tiles, both operand types and both grid orders: int8 -> int32 exactly;
  bf16 -> f32 within 1e-4 (float32 sums of exact bf16 products in other
  orders; the outputs are up to about 60 in magnitude, one float32 ulp there
  is 4e-6).
  The reference runs in a subprocess: importing the script sets a global
  compilation-cache directory and creates it.
* The probe's inputs are the reference's arithmetic, and the probe refuses
  to time anything but a card.
* Every row of ``scripts/kernel_variants.py``'s table applies to its source.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensortruth_tpu_torch import _build
from tensortruth_tpu_torch.ops.matmul import tc_matmul, tc_matmul_plain
from tensortruth_tpu_torch.scripts import kernel_variants, probe_int8_mma

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[2]
M, K, N, TILE = 256, 128, 256, 128
BF16_ATOL = 1e-4

_REFERENCE = """
import importlib.util, os, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

script, inputs, outputs = sys.argv[1:]
makedirs = os.makedirs
os.makedirs = lambda *a, **k: None  # the script creates a fixed cache directory at import
try:
    spec = importlib.util.spec_from_file_location("probe_int8_mxu_pallas", script)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
finally:
    os.makedirs = makedirs
jax.config.update("jax_compilation_cache_dir", None)
data = np.load(inputs)
out = {}
with pltpu.force_tpu_interpret_mode():
    for dt, operand, acc in (("bf16", jnp.bfloat16, jnp.float32), ("int8", jnp.int8, jnp.int32)):
        a, b = (jnp.asarray(data[f"{x}_{dt}"]).astype(operand) for x in ("a", "b"))
        for n_outer in (0, 1):
            o = probe.pallas_matmul(a, b, tile_m=%(tile)d, tile_n=%(tile)d, acc_dtype=acc, n_outer=bool(n_outer))
            out[f"{dt}_{n_outer}"] = np.asarray(o)
np.savez(outputs, **out)
"""


def _inputs():
    """bf16 operands as their exact float32 values, int8 as the reference's
    probe makes them."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32)).to(torch.bfloat16)
    a8 = np.clip(a.float().numpy() * 20, -127, 127).astype(np.int8)
    b8 = np.clip(b.float().numpy() * 20, -127, 127).astype(np.int8)
    return {"bf16": (a, b), "int8": (torch.from_numpy(a8), torch.from_numpy(b8))}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs for every (operand type, n_outer)."""
    tmp = tmp_path_factory.mktemp("b5")
    arrays = {f"{x}_{dt}": t.float().numpy() if dt == "bf16" else t.numpy()
              for dt, pair in _inputs().items() for x, t in zip("ab", pair)}
    np.savez(tmp / "in.npz", **arrays)
    subprocess.run(
        [sys.executable, "-c", _REFERENCE % {"tile": TILE}, str(REPO / "scripts" / "probe_int8_mxu_pallas.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        check=True, timeout=300, cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    with np.load(tmp / "out.npz") as out:
        return dict(out)


@pytest.mark.parametrize("operands", ["bf16", "int8"])
@pytest.mark.parametrize("n_outer", [False, True])
def test_plain_matches_reference_interpret(reference, operands, n_outer):
    a, b = _inputs()[operands]
    want = reference[f"{operands}_{int(n_outer)}"]
    got = tc_matmul(a, b, n_outer=n_outer)
    assert got.shape == (M, N)
    if operands == "int8":
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


def test_plain_int8_is_exact_at_the_extremes():
    """Sums far past float32's exact integers (2**24) stay exact: an odd sum
    near 127 * 127 * 4096 must not round to a float32 neighbour, and -128
    takes part."""
    a = torch.full((2, 4096), 127, dtype=torch.int8)
    a[1] = -128
    b = torch.full((4096, 3), 127, dtype=torch.int8)
    b[0, 1] = 2
    b[:, 2] = -128
    want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
    assert want[0, 1] % 2 == 1 and np.abs(want).min() > 2**24
    got = tc_matmul_plain(a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_inputs_are_the_reference_arithmetic():
    inputs = probe_int8_mma.make_inputs(16, 64, 32, device="cpu")
    rng = np.random.default_rng(0)
    a_f = rng.standard_normal((16, 64), dtype=np.float32)
    b_f = rng.standard_normal((64, 32), dtype=np.float32)
    a, b = inputs["bf16"]
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == (16, 64) and b.shape == (64, 32)
    np.testing.assert_array_equal(a.float().numpy(), torch.from_numpy(a_f).to(torch.bfloat16).float().numpy())
    a8, b8 = inputs["int8"]
    np.testing.assert_array_equal(a8.numpy(), np.clip(a_f * 20, -127, 127).astype(np.int8))
    np.testing.assert_array_equal(b8.numpy(), np.clip(b_f * 20, -127, 127).astype(np.int8))
    assert set(probe_int8_mma.VARIANTS) == {"tc_bf16", "tc_int8", "tc_bf16_resB", "tc_int8_resB"}


def test_probe_times_only_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_int8_mma.run(device="cpu")


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_apply_to_the_sources(name):
    """Every row of the variants table changes text that its kernel's source
    or hopper.cuh holds, once in the two, so the table stays in step with
    csrc/ (the variants are built on the card only)."""
    src, subs, csrc = kernel_variants._variant(name)
    assert csrc == _build.CSRC_DIR
    texts = [(csrc / f).read_text() for f in (src, "hopper.cuh")]
    assert all(sum(text.count(old) for text in texts) == 1 for old in subs)
    changed = kernel_variants.sources(name)
    assert ([changed[src], changed["hopper.cuh"]] != texts) == bool(subs)
    assert kernel_variants._variant(f"{name}@/elsewhere/csrc")[2] == pathlib.Path("/elsewhere/csrc")
