"""Kernel D's reader (port_bench/metrics/views.fused_mlp_fwd.roofline_pct.py)
on hand-made records: D's device seconds by kernel name against the nets'
forward FLOPs, read only where D's launch counter shows it took both nets of
every batch of a window of views."""
import json
import types

import pytest

from port_bench import counts, harness

NAME = "views.fused_mlp_fwd.roofline_pct"
FLAGS = json.loads((harness.BENCH_DIR / "configs" / "append_smpl_params_flagship.json")
                   .read_text())["flags"]


def reader():
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py", f"test_{NAME}")


class Summary(types.SimpleNamespace):
    def kernel_seconds(self, *fragments):
        return sum(s for name, s in self.kernels.items() if any(f in name for f in fragments))


def views_record(launches=16, seconds=0.25, kind="views"):
    kernels = {"void fused_mlp_fwd_kernel<256>(Net)": seconds,
               "void fused_mlp_v2_fwd_kernel<256>(Net)": 9.0,     # B's name is not D's
               "ampere_bf16_s16816gemm": 5.0}
    return {"kind": kind, "flags": FLAGS, "summary": Summary(kernels=kernels),
            "eval_batches": 8, "eval_padded_rays": 16384, "launches": {"fused_mlp_fwd": launches}}


def test_the_share_of_the_bound_from_the_flagship_counts():
    flops = 2.0 * 16384 * (64 + 192) * 925_824
    assert counts.net_forward_flops(FLAGS, 16384) == flops
    got = reader().read(views_record())
    assert got == pytest.approx(100.0 * flops / counts.PEAK_BF16_FLOPS / 0.25)
    assert 0 < got < 100


@pytest.mark.parametrize("launches", [0, 15, 17])
def test_none_unless_d_took_both_nets_of_every_batch(launches):
    assert reader().read(views_record(launches=launches)) is None


@pytest.mark.parametrize("record", [None, views_record(kind="train"), views_record(seconds=0.0)])
def test_none_off_the_views_kind_or_without_d_on_the_device(record):
    assert reader().read(record) is None
