"""The run's end check on loaded modules, and its refusal without a card."""
import subprocess
import sys

from port_bench import harness

ROOT = str(harness.CHECKOUT)


def _forbidden_after(imports: str) -> str:
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); {imports}; "
            "from port_bench import harness; print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_the_port_alone_passes():
    assert _forbidden_after("import smpl_nerf_tpu_torch.training.solver, "
                            "smpl_nerf_tpu_torch.render.batched") == "[]"


def test_the_jax_package_fails():
    found = _forbidden_after("import smpl_nerf_tpu")
    assert "'smpl_nerf_tpu'" in found


def test_names_are_compared_whole():
    sys.modules.setdefault("smpl_nerf_tpu_torch_probe", sys)
    try:
        assert "smpl_nerf_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["smpl_nerf_tpu_torch_probe"]


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "smpl_nerf.train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
