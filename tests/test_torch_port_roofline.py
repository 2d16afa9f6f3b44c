"""Kernel F's plain version and the port's roofline script, on the CPU.

`relu_matmul_reference` is held against the JAX script's per-layer Pallas
kernel (`scripts/mlp_roofline.py:_pallas_layer`, loaded from its file and run
in interpret mode) on the same bf16 inputs. Both multiply bf16 values exactly
and sum in float32, in another order, so the sums can differ in the last
float32 bit and land on either side of a bf16 rounding boundary: outputs are
held to one bf16 step, 2^-7 relative.

`cli/mlp_roofline.py` runs end to end at a small size with `--device cpu`,
where every wrapper takes its plain version and a record carries a host-clock
`host_ms`, never the card's `ms`.
"""
import _torch_threads  # noqa: F401

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smpl_nerf_tpu_torch.cli import mlp_roofline
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, relu_matmul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -7


@pytest.fixture(scope="module")
def jax_script():
    """scripts/mlp_roofline.py as a module. Importing it points JAX's
    compilation cache at a directory outside the checkout; undo that."""
    before = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "jax_mlp_roofline", os.path.join(REPO, "scripts", "mlp_roofline.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    jax.config.update("jax_compilation_cache_dir", before)
    return module


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a torch and a jax array."""
    t = torch.tensor(rng.randn(*shape).astype(np.float32) * scale).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("n,K,N,tile", [(64, 32, 128, 16), (128, 256, 256, 128), (48, 64, 32, 48)])
def test_relu_matmul_plain_version_matches_the_pallas_layer_in_interpret_mode(
        rng, jax_script, n, K, N, tile):
    x_t, x_j = _bf16_pair(rng, (n, K))
    w_t, w_j = _bf16_pair(rng, (K, N), 0.05)
    want = np.asarray(jax_script._pallas_layer(tile, True)(x_j, w_j).astype(jnp.float32))
    got = relu_matmul.relu_matmul(x_t, w_t)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP, atol=1e-6)
    assert float(got.float().min()) == 0.0 and float(got.float().max()) > 0.0
    exact = np.maximum(x_t.float().numpy().astype(np.float64)
                       @ w_t.float().numpy().astype(np.float64), 0.0)
    np.testing.assert_allclose(got.float().numpy(), exact, rtol=BF16_STEP, atol=1e-6)


def test_relu_matmul_kernel_limits_are_stated():
    assert relu_matmul.kernel_supports(256, 256) == ""
    assert relu_matmul.kernel_supports(1024, 1024) == ""
    assert "multiple of" in relu_matmul.kernel_supports(48, 128)
    assert "multiple of" in relu_matmul.kernel_supports(64, 96)
    # the persistent grid walks tiles: rows are bounded only by int32 TMA coordinates
    assert relu_matmul.MAX_ROWS == 2 ** 31 - 1


@pytest.mark.parametrize("K", [32, 64, 96, 160, 256, 512, 1024, 2048])
@pytest.mark.parametrize("N", [128, 256, 384, 512, 1024, 1152])
def test_relu_matmul_kernel_takes_every_shape_the_first_kernel_took(K, N):
    # the first kernel F took K a multiple of 32 and N a multiple of 128
    assert relu_matmul.kernel_supports(K, N) == ""


def test_roofline_main_runs_both_parts_on_the_cpu(capsys):
    records = mlp_roofline.main(["--part", "all", "--rows", "192", "--reps", "2", "--depth", "3",
                                 "--widths", "128", "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == records
    chain = [r for r in records if r["bench"] == "chain"]
    fused = [r for r in records if r["bench"] == "fusedmlp"]
    assert [r["impl"] for r in chain] == ["library", "kernel"]
    assert [r["impl"] for r in fused] == ["plain", "fused_v1", "fused_v2"]
    for r in records:
        assert r["device"] == "cpu" and r["card"] is None and r["width"] == 128
        assert "ms" not in r and "fwd_ms" not in r            # no card, no device time
    for r in chain:
        assert r["host_ms"] > 0 and r["depth"] == 3 and r["rows"] == 192
        # the plain version sums in float32, the library's bf16 matmul rounds alike
        assert r["max_abs_diff_kernel_library"] < 0.1
        # a live chain, and a difference of at most one bf16 step of the largest
        # output for each layer that could flip a rounding
        assert r["mean_abs_output"] > 0
        assert r["max_abs_diff_kernel_library"] <= 3 * BF16_STEP * r["max_abs_output"]
    for r in fused:
        assert r["fwd_host_ms"] > 0 and r["fwdbwd_host_ms"] > 0 and "refused" not in r


def test_the_fused_kernels_state_why_they_refuse_width_1024():
    net = RenderRayNet(width=1024, compute_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    spec = fused_mlp.spec_from_model(net)
    for reason in (fused_mlp.kernel_supports(spec), fused_mlp_v2.kernel_supports(spec)):
        assert "width" in reason and "256" in reason
    flops = mlp_roofline._fused_flops_fwd(fused_mlp.MlpSpec(), 10)
    assert flops == 2 * 10 * 607872                            # the 8x256 net's MAC count


def test_the_root_shim_runs_on_the_cpu_and_the_default_device_needs_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run(
        [sys.executable, os.path.join(REPO, "mlp_roofline_torch.py"), "--part", "chain",
         "--rows", "64", "--reps", "1", "--depth", "2", "--widths", "128", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    lines = [json.loads(line) for line in done.stdout.splitlines()]
    assert [r["impl"] for r in lines] == ["library", "kernel"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mlp_roofline.main(["--part", "chain", "--rows", "64"])
