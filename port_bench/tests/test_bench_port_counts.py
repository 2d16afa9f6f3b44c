"""counts.py against counts made by hand for both configurations."""
import json

import pytest

from port_bench import counts, harness

FLAGS = {c["name"]: json.loads((harness.CHECKOUT / c["file"]).read_text())["flags"]
         for c in harness.load_json(harness.CHECKOUT / "BENCHMARK.json")["configs"]}


def _by_hand_net(pos_plus_prefix: int) -> int:
    w, d = 256, 24
    return (pos_plus_prefix * w                       # positions_pose_input
            + 6 * w * w + (w + pos_plus_prefix) * w   # positional_net, the skip before 4
            + w * w + w                               # additional layer, sigma head
            + (w + d) * (w // 2)                      # directional_input
            + (w // 2) ** 2 + (w // 2) * 3)           # directional_net.0, rgb head


def test_macs_per_sample_match_the_hand_counts():
    sn = counts.macs_per_sample(FLAGS["smpl_nerf_arm_angles"])
    ap = counts.macs_per_sample(FLAGS["append_smpl_params_flagship"])
    assert sn["coarse"] == sn["fine"] == _by_hand_net(60) == 607_872
    assert ap["coarse"] == ap["fine"] == _by_hand_net(60 + 69 * 9) == 925_824
    assert sn["warp"] == (60 + 2 * 20) * 256 + 256 * 3 == 26_368
    assert ap["warp"] == 0


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_rows_per_step_and_per_view(name):
    s = counts.samples_per_ray(FLAGS[name])
    assert (s["coarse"], s["fine"]) == (64, 192)
    assert 2048 * (s["coarse"] + s["fine"]) == 524_288            # rows a step
    assert 128 * 128 * (s["coarse"] + s["fine"]) == 4_194_304     # rows a 128x128 view


def test_flops_a_step_and_a_view():
    sn, ap = FLAGS["smpl_nerf_arm_angles"], FLAGS["append_smpl_params_flagship"]
    assert counts.net_forward_flops(sn, 2048) * 3 == pytest.approx(524_288 * 607_872 * 6)
    assert counts.train_flops(sn, 2048) == pytest.approx(524_288 * (607_872 + 26_368) * 6)
    assert counts.train_flops(ap, 2048) == pytest.approx(524_288 * 925_824 * 6)
    assert counts.forward_flops(ap, 16384) == pytest.approx(4_194_304 * 925_824 * 2)
    assert counts.forward_flops(sn, 16384) == pytest.approx(4_194_304 * (607_872 + 26_368) * 2)
