"""The port's dataset generation against the JAX package, on the CPU.

`ops/raymesh` (`intersect_rays_multi`, `barycentric_transfer`,
`dependent_pixels`), `render/raytrace` (`render_scene` with vertex colours and
with a UV texture, `get_warp`) on a posed procedural human, and
`data/generate.create_dataset` for the four dataset types (and
--supersample, AMASS pose sequences, the split helper, the texture reader,
the flag surface and the `create_dataset_torch.py --device cpu` entry point),
each against the JAX package with the same flags and seed.

Sizes: 16x16 datasets of 6 views (a 3-camera circle x 2 arm angles), 24x24
renders of 3 cameras, the 3,120-vertex procedural human.

Tolerances, each with its reason: both packages trace the same float32 rays
(bit-equal) against the same mesh (LBS vertices within ~6e-8), but a ray that
passes through a triangle edge can take another face, or miss, in one
package. So a render is held on the pixels whose closest hit is the same
face in both (recomputed by both packages' `intersect_rays`): colour within
1 level, depth and warp within 1e-4; hit masks must agree on at least 99.5 %
of the pixels and the face on at least 98 % (16x16 views of a symmetric
body put a few centre pixels on seams). transforms.json within 1e-6; the
train/val split and the config's keys exactly.
"""
import _torch_threads  # noqa: F401

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.core import rays as jax_rays
from smpl_nerf_tpu.data import generate as jax_generate
from smpl_nerf_tpu.models import smpl as jax_smpl
from smpl_nerf_tpu.ops import raymesh as jax_raymesh
from smpl_nerf_tpu.render import raytrace as jax_raytrace
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch.core import cameras
from smpl_nerf_tpu_torch.data import generate, png
from smpl_nerf_tpu_torch.models import smpl
from smpl_nerf_tpu_torch.ops import raymesh
from smpl_nerf_tpu_torch.render import raytrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIT_SHARE, FACE_SHARE = 0.995, 0.98
T_ATOL, LEVEL, META_ATOL = 1e-4, 1, 1e-6


def to_np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def humans():
    return jax_smpl.procedural_human(), smpl.procedural_human()


def _posed(humans, pose):
    jm, pm = humans
    pose = np.asarray(pose, np.float32).reshape(-1)
    return (np.asarray(jax_smpl.smpl_forward(jm, jnp.zeros(10), jnp.asarray(pose))),
            to_np(smpl.smpl_forward(pm, np.zeros(10), torch.from_numpy(pose))))


def _arm_pose(angle_deg):
    pose = np.zeros(69, np.float32)
    pose[[38, 41]] = np.deg2rad(angle_deg)
    return pose


def _same_faces(cam, h, w, fov, jverts, pverts, faces):
    """(hit flags agree [h*w], same closest face and both hit or both miss
    [h*w]) of one camera's pixel rays, each package on its own vertices."""
    focal = jax_rays.focal_from_fov(w, fov)
    o, d = jax_rays.get_rays(h, w, focal, np.asarray(cam, np.float32))
    o, d = np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    jh = jax_raymesh.intersect_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(jverts),
                                    jnp.asarray(faces))
    ph = raymesh.intersect_rays(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(pverts), faces)
    jhit, phit = np.asarray(jh.hit), ph.hit.numpy()
    return jhit == phit, (jhit == phit) & (np.asarray(jh.face_idx) == ph.face_idx.numpy())


# ------------------------------------------------------------------ ray-mesh

def _rays_at_the_body(rng, verts, n=400):
    origins = np.tile(np.asarray([[0.3, 0.2, 2.4]], np.float32), (n, 1))
    target = verts[rng.randint(0, len(verts), n)] + 0.05 * rng.randn(n, 3)
    dirs = (target - origins).astype(np.float32)
    return origins, dirs


def test_intersect_rays_multi_matches_jax(rng, humans):
    jverts, pverts = _posed(humans, _arm_pose(30))
    o, d = _rays_at_the_body(rng, jverts)
    jt, jhit = jax_raymesh.intersect_rays_multi(jnp.asarray(o), jnp.asarray(d), jnp.asarray(jverts),
                                                jnp.asarray(humans[0].faces))
    pt, phit = raymesh.intersect_rays_multi(torch.from_numpy(o), torch.from_numpy(d),
                                            torch.from_numpy(pverts), humans[1].faces)
    jt, jhit, pt, phit = np.asarray(jt), np.asarray(jhit), to_np(pt), phit.numpy()
    assert pt.shape == (len(o), 4) and (phit.sum(-1) >= 2).mean() > 0.3     # entries and exits
    assert np.all(np.isinf(pt[~phit]))                                       # inf pads misses
    assert np.all(np.diff(np.where(phit, pt, np.inf), axis=-1)[phit[:, 1:]] > 0)   # nearest first
    same = np.all(jhit == phit, -1)
    same &= np.all(np.where(jhit & phit, np.abs(np.where(jhit, jt, 0) - np.where(phit, pt, 0)),
                            0) <= T_ATOL, -1)
    assert same.mean() >= FACE_SHARE


def test_barycentric_transfer_and_dependent_pixels_match_jax(rng, humans):
    jm, pm = humans
    canon_j, canon_p = _posed(humans, np.zeros(69))
    goal_j, goal_p = _posed(humans, _arm_pose(45))
    o, d = _rays_at_the_body(rng, canon_j)
    jhits = jax_raymesh.intersect_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(canon_j),
                                       jnp.asarray(jm.faces))
    same_hits = raymesh.RayHits(*(torch.from_numpy(np.array(x)) for x in jhits))
    want = np.asarray(jax_raymesh.barycentric_transfer(jhits, jnp.asarray(jm.faces),
                                                       jnp.asarray(goal_j)))
    got = to_np(raymesh.barycentric_transfer(same_hits, pm.faces, torch.from_numpy(goal_p)))
    assert np.asarray(jhits.hit).mean() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[~np.asarray(jhits.hit)] == 0)

    cam = cameras.get_circle_pose(20.0, 2.4).astype(np.float32)
    want_px, want_in = jax_raymesh.dependent_pixels(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(canon_j), jnp.asarray(goal_j),
        jnp.asarray(jm.faces), cam, 32, 32, 30.0)
    got_px, got_in = raymesh.dependent_pixels(torch.from_numpy(o), torch.from_numpy(d),
                                              torch.from_numpy(canon_p), torch.from_numpy(goal_p),
                                              pm.faces, cam, 32, 32, 30.0)
    assert got_px.dtype == torch.int32 and got_in.numpy().mean() > 0.3
    agree = (np.all(got_px.numpy() == np.asarray(want_px), -1)
             & (got_in.numpy() == np.asarray(want_in)))
    assert agree.mean() >= FACE_SHARE
    assert np.all(got_px.numpy()[~got_in.numpy()] == -1)


# ---------------------------------------------------------------- ray tracer

@pytest.mark.parametrize("shading", ["vertex_colors", "texture"])
def test_render_scene_and_get_warp_match_jax(rng, humans, shading):
    jm, pm = humans
    canon_j, canon_p = _posed(humans, np.zeros(69))
    goal_j, goal_p = _posed(humans, _arm_pose(35))
    res, fov = 24, np.pi / 3
    if shading == "texture":
        uv = rng.uniform(0, 1, (pm.num_vertices, 2)).astype(np.float32)
        kwargs = dict(uv=uv, texture=rng.randint(0, 256, (20, 12, 3)).astype(np.uint8))
    else:
        kwargs = dict(vertex_colors=pm.vertex_colors)
    hits, faces_same = [], []
    for cam in cameras.get_circle_poses(-60, 60, 3, 2.4)[0]:
        want_img, want_depth = jax_raytrace.render_scene(goal_j, jm.faces, cam, res, res, fov,
                                                         return_depth=True, **kwargs)
        img, depth = raytrace.render_scene(goal_p, pm.faces, cam, res, res, fov,
                                           return_depth=True, **kwargs)
        want_warp, want_wdepth = jax_raytrace.get_warp(canon_j, goal_j, jm.faces, cam, res, res,
                                                       fov)
        warp, wdepth = raytrace.get_warp(canon_p, goal_p, pm.faces, cam, res, res, fov)
        assert img.dtype == np.uint8 and img.shape == (res, res, 3)
        assert warp.dtype == wdepth.dtype == np.float32
        hit_same, same = _same_faces(cam, res, res, fov, goal_j, goal_p, jm.faces)
        hits.append(hit_same)
        faces_same.append(same)
        same = same.reshape(res, res)
        diff = np.abs(img.astype(int) - want_img.astype(int)).max(-1)
        assert diff[same].max() <= LEVEL
        np.testing.assert_allclose(depth[same], want_depth[same], atol=T_ATOL)
        np.testing.assert_allclose(wdepth[same], want_wdepth[same], atol=T_ATOL)
        np.testing.assert_allclose(warp[same], want_warp[same], atol=T_ATOL)
        assert np.all(img[depth == 0] == 255)                      # white background
        assert np.abs(warp).max() > 1e-2                           # the raised arms warp
    assert np.mean(hits) >= HIT_SHARE and np.mean(faces_same) >= FACE_SHARE


# ---------------------------------------------------------------- generator

def _generate_both(tmp_path, flags):
    out = {}
    for name, parser_fn, gen in (
            ("jax", jax_config.dataset_config_parser, jax_generate.create_dataset),
            ("port", port_config.dataset_config_parser, None)):
        parser = parser_fn()
        args = parser.parse_args(flags + [f"--save_dir={tmp_path / name}"])
        split = (gen(args, parser) if gen else
                 generate.create_dataset(args, parser, device="cpu"))
        out[name] = (str(tmp_path / name), [list(map(int, s)) for s in split])
    return out


def _config_keys(path):
    with open(path) as fh:
        return [line.split(" = ")[0] for line in fh.read().splitlines()]


def _check_split(humans, jdir, pdir, dataset_type, res, ss=1):
    """Files of one split against JAX's on the pixels whose face agrees;
    returns (hit agreement, face agreement) over its pixels."""
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    with open(os.path.join(jdir, "transforms.json")) as fh:
        want = json.load(fh)
    with open(os.path.join(pdir, "transforms.json")) as fh:
        got = json.load(fh)
    assert list(got) == list(want)
    assert got["camera_angle_x"] == want["camera_angle_x"]
    for key in ("image_transform_map", "image_pose_map"):
        if key in want:
            assert list(got[key]) == list(want[key])
            for name in want[key]:
                np.testing.assert_allclose(got[key][name], want[key][name], atol=META_ATOL)
    for key in ("betas", "expression"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], atol=META_ATOL)
    hits, faces_same = [], []
    for name, cam in want["image_transform_map"].items():
        pose = (np.asarray(want["image_pose_map"][name]) if dataset_type != "nerf"
                else np.zeros(69))
        jverts, pverts = _posed(humans, pose)
        hit_same, same = _same_faces(cam, res * ss, res * ss, want["camera_angle_x"], jverts,
                                     pverts, humans[0].faces)
        hits.append(hit_same)
        faces_same.append(same)
        same = same.reshape(res, ss, res, ss).all((1, 3))       # every subpixel of a pixel
        want_img = cv2.imread(os.path.join(jdir, name)).astype(int)
        img = png.read_png(os.path.join(pdir, name)).astype(int)
        assert img.shape == want_img.shape
        diff = np.abs(img - want_img).max(-1)
        assert diff[:, :res][same].max() <= LEVEL, name
        if dataset_type == "pix2pix":                       # the depth image beside it
            assert diff[:, res:][same].max() <= LEVEL, name
        if dataset_type == "smpl":
            stem = name[len("img_"):-len(".png")]
            for kind in ("warp", "depth"):
                w = np.load(os.path.join(jdir, f"{kind}_{stem}.npy"))
                g = np.load(os.path.join(pdir, f"{kind}_{stem}.npy"))
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_allclose(g[same], w[same], atol=T_ATOL)
    return hits, faces_same


@pytest.mark.parametrize("dataset_type", ["nerf", "smpl_nerf", "smpl", "pix2pix"])
def test_create_dataset_matches_jax(tmp_path, humans, dataset_type):
    res = 16
    flags = [f"--dataset_type={dataset_type}", f"--resolution={res}", "--camera_path=circle",
             "--number_steps=3", "--multi_human_pose=1", "--human_number_steps=2",
             "--human_start_angle=0", "--human_end_angle=60", "--seed=3"]
    out = _generate_both(tmp_path, flags)
    (jroot, jsplit), (proot, psplit) = out["jax"], out["port"]
    assert psplit == jsplit
    assert sum(map(len, psplit)) == (3 if dataset_type == "nerf" else 6)   # nerf: no poses
    assert (_config_keys(os.path.join(proot, "create_dataset_config.txt"))
            == _config_keys(os.path.join(jroot, "create_dataset_config.txt")))
    hits, faces_same = [], []
    for split in ("train", "val"):
        h, f = _check_split(humans, os.path.join(jroot, split), os.path.join(proot, split),
                            dataset_type, res)
        hits += h
        faces_same += f
    assert np.mean(hits) >= HIT_SHARE and np.mean(faces_same) >= FACE_SHARE


def test_supersample_matches_jax_and_is_ignored_for_smpl(tmp_path, humans, capsys):
    res, ss = 12, 2
    flags = ["--dataset_type=smpl_nerf", f"--resolution={res}", "--camera_path=circle",
             "--number_steps=2", "--human_number_steps=2", "--human_start_angle=0",
             "--human_end_angle=60", f"--supersample={ss}"]
    out = _generate_both(tmp_path / "nerf", flags)
    for split in ("train", "val"):
        _check_split(humans, os.path.join(out["jax"][0], split),
                     os.path.join(out["port"][0], split), "smpl_nerf", res, ss)
    parser = port_config.dataset_config_parser()
    smpl_flags = ["--dataset_type=smpl", f"--resolution={res}", "--camera_path=circle",
                  "--number_steps=2", "--human_number_steps=2"]
    for name, extra in (("ss", [f"--supersample={ss}"]), ("plain", [])):
        generate.create_dataset(parser.parse_args(
            smpl_flags + extra + [f"--save_dir={tmp_path / name}"]), parser, device="cpu")
    assert "supersample ignored for dataset_type=smpl" in capsys.readouterr().out
    for split in ("train", "val"):
        for f in os.listdir(tmp_path / "plain" / split):
            a, b = tmp_path / "plain" / split / f, tmp_path / "ss" / split / f
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(b), np.load(a))
            elif f.endswith(".png"):
                np.testing.assert_array_equal(png.read_png(str(b)), png.read_png(str(a)))


@pytest.mark.parametrize("multi,frames_per_view", [(0, 1), (0, 2), (1, 1)])
def test_pose_sequences_and_their_camera_layouts_match_jax(rng, tmp_path, multi,
                                                           frames_per_view):
    seq = str(tmp_path / "walk.npz")
    np.savez(seq, poses=rng.uniform(-0.5, 0.5, (9, 156)).astype(np.float32))
    want = jax_generate.load_pose_sequence(seq, 1, 8, 2)
    got = generate.load_pose_sequence(seq, 1, 8, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    flags = ["--dataset_type=smpl_nerf", "--resolution=4", "--camera_path=circle",
             "--number_steps=2", f"--smpl_sequence_file={seq}", "--sequence_skip=3",
             f"--multi_human_pose={multi}", f"--frames_per_view={frames_per_view}"]
    out = _generate_both(tmp_path, flags)
    assert out["port"][1] == out["jax"][1]
    for split in ("train", "val"):
        with open(os.path.join(out["jax"][0], split, "transforms.json")) as fh:
            want = json.load(fh)
        with open(os.path.join(out["port"][0], split, "transforms.json")) as fh:
            got = json.load(fh)
        for key in ("image_transform_map", "image_pose_map"):
            assert list(got[key]) == list(want[key])
            for name in want[key]:
                np.testing.assert_allclose(got[key][name], want[key][name], atol=META_ATOL)


def test_split_helper_flag_surface_and_texture_reader(tmp_path):
    for seed in (0, 4):
        np.random.seed(seed)
        want = jax_generate.disjoint_indices(11, 0.7)
        np.random.seed(seed)
        got = generate.disjoint_indices(11, 0.7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    jp, pp = jax_config.dataset_config_parser(), port_config.dataset_config_parser()
    want = {a.dest: a.default for a in jp._actions}
    assert {a.dest: a.default for a in pp._actions} == want
    tex = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    path = str(tmp_path / "tex.png")
    cv2.imwrite(path, tex)                                    # cv2 writes BGR
    np.testing.assert_array_equal(generate.load_texture(path), tex[..., ::-1])
    assert generate.load_texture(None) is None
    with pytest.raises(ValueError, match="tex.jpg"):
        generate.load_texture(str(tmp_path / "tex.jpg"))


def test_create_dataset_torch_entry_point_on_cpu(tmp_path):
    """The root script with --device cpu writes a dataset; without --device it
    asks for the card, and a host without one refuses."""
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, os.path.join(REPO, "create_dataset_torch.py"), "--dataset_type=smpl",
            "--resolution=8", "--camera_path=circle", "--number_steps=2",
            "--human_number_steps=2"]
    done = subprocess.run(base + ["--device", "cpu", f"--save_dir={tmp_path / 'cpu'}"],
                          capture_output=True, text=True, env=env, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    with open(tmp_path / "cpu" / "create_dataset_config.txt") as fh:
        text = fh.read()
    train_index = int(text.split("train_index = [")[1].split("]")[0])
    stem = f"{train_index:03d}"
    assert sorted(os.listdir(tmp_path / "cpu" / "train")) == [
        f"depth_{stem}.npy", f"img_{stem}.png", "transforms.json", f"warp_{stem}.npy"]
    assert f"val_index = [{1 - train_index}]" in text
    if not torch.cuda.is_available():
        done = subprocess.run(base + [f"--save_dir={tmp_path / 'card'}"], capture_output=True,
                              text=True, env=env, timeout=120)
        assert done.returncode != 0 and "no CUDA" not in done.stdout
        assert "CUDA GPU" in done.stderr and not (tmp_path / "card").exists()
