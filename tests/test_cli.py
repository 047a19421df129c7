import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
    procedural_super_scene, torus_mesh, write_scene_files)
from opencl_montecarlo_path_tracing_tpu.utils import pam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The built-in super scene in the reference's text formats (96
    triangles, 2 lights), plus the 32-triangle torus.txt the reference
    ships beside triangles.txt for the mesh swap."""
    scene = procedural_super_scene()
    d = tmp_path_factory.mktemp("scene")
    write_scene_files(scene, str(d))
    torus = tmp_path_factory.mktemp("torus")
    write_scene_files(dataclasses.replace(
        scene, triangles=torus_mesh(n_major=4, n_minor=4)), str(torus))
    os.replace(torus / "triangles.txt", d / "torus.txt")
    return str(d)


def run_cli(args, cwd, extra_env=None):
    env = dict(os.environ)
    env["PT_PLATFORM"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "opencl_montecarlo_path_tracing_tpu"] + args,
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_cli_simple(tmp_path):
    r = run_cli(["simple", "32", "32", "8", "--spp", "2", "--seed", "1"],
                cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    img = pam.load_pam(str(tmp_path / "result.ppm"))
    assert (img.width, img.height) == (32, 32)
    assert "rendering" in r.stdout and "GB/s" in r.stdout


def test_cli_pam16(tmp_path):
    """--pam-maxval 65535 writes a 16-bit PAM whose samples are the 8-bit
    display values mapped onto [0, 65535] (the IO layer's 16-bit support,
    pamalign.h:156-166/226-231, reachable from the CLI)."""
    r = run_cli(["simple", "16", "16", "8", "--spp", "2", "--seed", "1",
                 "--pam-maxval", "65535", "--out", "r16.ppm"],
                cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    r8 = run_cli(["simple", "16", "16", "8", "--spp", "2", "--seed", "1",
                  "--out", "r8.ppm"], cwd=str(tmp_path))
    assert r8.returncode == 0, r8.stderr
    img = pam.load_pam(str(tmp_path / "r16.ppm"))
    assert (img.maxval, img.depth) == (65535, 16)
    img8 = pam.load_pam(str(tmp_path / "r8.ppm"))
    # same display scale: v16/257 == v8 up to the different rounding
    # (trunc at 8 bit vs round at 16)
    d = (np.asarray(img.data, np.float64) / 257.0
         - np.asarray(img8.data, np.float64))
    assert np.abs(d).max() <= 1.0
    assert int(np.asarray(img.data)[..., 3].min()) == 65535


def test_cli_kernel_debug_prints(tmp_path, scene_dir):
    """PT_KERNEL_DEBUG=1 streams aggregate DDA statistics from inside the
    jitted grid traversal - the analog of the reference's commented device
    printfs (trianglegrid/pathtracer.ocl:192); off by default."""
    args = ["trianglegrid", "24", "8", "--spp", "1", "--seed", "1",
            "--scene-dir", scene_dir]
    r = run_cli(args, cwd=str(tmp_path), extra_env={"PT_KERNEL_DEBUG": "1"})
    assert r.returncode == 0, r.stderr
    assert "[grid DDA]" in r.stdout
    assert "cells_visited=" in r.stdout
    r_off = run_cli(args, cwd=str(tmp_path))
    assert r_off.returncode == 0, r_off.stderr
    assert "[grid DDA]" not in r_off.stdout


def test_cli_simplecpu(tmp_path):
    r = run_cli(["simplecpu", "16", "16", "--spp", "2", "--seed", "1"],
                cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    img = pam.load_pam(str(tmp_path / "resultCPU.ppm"))
    assert (img.width, img.height) == (16, 16)


def test_cli_super_on_reference_scene(tmp_path, scene_dir):
    r = run_cli(["super", "24", "24", "--spp", "2", "--seed", "3",
                 "--scene-dir", scene_dir], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "Number of triangles: 96" in r.stdout
    img = pam.load_pam(str(tmp_path / "result.ppm"))
    assert np.asarray(img.data)[..., 3].min() == 255


def test_cli_all_variants_smoke(tmp_path, scene_dir):
    variants = [
        ["superlmem", "16", "16"],
        ["nodof", "8", "8"],
        ["trianglegrid", "12", "12", "2.5"],
        ["bidirectional", "12", "12", "32"],
        ["metropolis", "8", "8", "16", "2"],
        ["metropolis_vlpgrid", "8", "8", "16", "2", "3.0"],
    ]
    for v in variants:
        r = run_cli(v + ["--spp", "1", "--seed", "2",
                         "--scene-dir", scene_dir], cwd=str(tmp_path))
        assert r.returncode == 0, (v, r.stderr[-2000:])
        assert os.path.exists(tmp_path / "result.ppm")
        os.unlink(tmp_path / "result.ppm")


def test_cli_profile_stages(tmp_path, scene_dir):
    r = run_cli(["metropolis_vlpgrid", "8", "8", "16", "2", "3.0",
                 "--spp", "1", "--seed", "2", "--scene-dir", scene_dir,
                 "--profile-stages"], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "light tracer + metropolis" in out
    assert "min/max reduction + VLPs grid init" in out
    assert "rendering" in out


def test_cli_profile_stages_dynamic_grid_res(tmp_path, scene_dir):
    """With --dynamic-grid-res the staged vlpgrid report
    shows the reference's exact 7-stage list (vlpgrid .c:691-705) in
    order, including the blocking host box read (.c:609) and the
    box-derived 'VLPs grid size' printout (.c:639)."""
    r = run_cli(["metropolis_vlpgrid", "8", "8", "16", "2", "3.0",
                 "--spp", "1", "--seed", "2", "--scene-dir", scene_dir,
                 "--profile-stages", "--dynamic-grid-res"],
                cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    stages = ["light paths random sampling",
              "light paths metropolis sampling",
              "VLPs min/max reduction (compute bounding box)",
              "Read VLPs bounding box",
              "init VLPs grid",
              "rendering",
              "read render data"]
    pos = -1
    for s in stages:
        assert s in out, s
        assert out.index(s) > pos      # reference report order
        pos = out.index(s)
    assert "VLPs grid size:" in out


def test_cli_quirks_mode(tmp_path):
    r = run_cli(["simple", "16", "16", "--spp", "1", "--seed", "1",
                 "--quirks", "reference"], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr


def test_cli_torus_mesh_swap(tmp_path, scene_dir):
    """The reference workflow 'swap in torus.txt by renaming' is a flag."""
    r = run_cli(["super", "16", "16", "--spp", "1", "--seed", "3",
                 "--scene-dir", scene_dir, "--triangles-file", "torus.txt"],
                cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-1500:]
    assert "Number of triangles: 32" in r.stdout


def test_cli_missing_scene_dir_errors_cleanly(tmp_path):
    r = run_cli(["super", "8", "8", "--scene-dir", str(tmp_path / "nope")],
                cwd=str(tmp_path))
    assert r.returncode == 1
    assert "missing scene file" in r.stderr


def test_cli_checkpoint_resume(tmp_path, scene_dir):
    ck = str(tmp_path / "film.npz")
    args = ["super", "16", "16", "--spp", "4", "--seed", "5",
            "--scene-dir", scene_dir, "--checkpoint", ck,
            "--spp-per-step", "2"]
    r = run_cli(args, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-1500:]
    assert "checkpointed, 4 spp" in r.stdout
    img1 = pam.load_pam(str(tmp_path / "result.ppm")).data.copy()
    # re-run: resumes (no-op) and writes the same image
    r = run_cli(args, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-1500:]
    img2 = pam.load_pam(str(tmp_path / "result.ppm")).data
    np.testing.assert_array_equal(img1, img2)
    # and equals the unchecckpointed render
    r = run_cli(["super", "16", "16", "--spp", "4", "--seed", "5",
                 "--scene-dir", scene_dir, "--out", "plain.ppm"],
                cwd=str(tmp_path))
    img3 = pam.load_pam(str(tmp_path / "plain.ppm")).data
    np.testing.assert_allclose(img1.astype(int), img3.astype(int), atol=1)


def test_cli_shard(tmp_path, scene_dir):
    """--shard routes through the parallel/mesh.py sharded renderers on a
    virtual 8-device CPU mesh: 1-D spp sharding, 2-D rows x spp, and a
    VLP variant whose light pass shards too."""
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    r = run_cli(["super", "16", "16", "--spp", "8", "--seed", "3",
                 "--scene-dir", scene_dir, "--shard", "8"],
                cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "rendering (sharded 8)" in r.stdout
    r = run_cli(["bidirectional", "16", "16", "32", "--spp", "4",
                 "--seed", "3", "--scene-dir", scene_dir,
                 "--shard", "4x2"], cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "rendering (sharded 4x2)" in r.stdout
    assert os.path.exists(tmp_path / "result.ppm")


def test_cli_shard_errors(tmp_path, scene_dir):
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    # more devices than exist
    r = run_cli(["super", "16", "16", "--spp", "8", "--scene-dir",
                 scene_dir, "--shard", "64"], cwd=str(tmp_path),
                extra_env=env)
    assert r.returncode == 1 and "needs 64 devices" in r.stderr
    # malformed spec
    r = run_cli(["super", "16", "16", "--scene-dir", scene_dir,
                 "--shard", "axb"], cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 1 and "bad --shard spec" in r.stderr
    # indivisible spp
    r = run_cli(["super", "16", "16", "--spp", "7", "--scene-dir",
                 scene_dir, "--shard", "8"], cwd=str(tmp_path),
                extra_env=env)
    assert r.returncode == 1 and "--shard 8" in r.stderr
    # --checkpoint composes with 1-D --shard only, not 2-D meshes
    r = run_cli(["super", "16", "16", "--spp", "8", "--scene-dir",
                 scene_dir, "--shard", "4x2",
                 "--checkpoint", str(tmp_path / "ck.npz")],
                cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 1 and "1-D spp-sharded" in r.stderr
    # --dynamic-grid-res needs the single-device pipeline
    r = run_cli(["metropolis_vlpgrid", "16", "16", "--spp", "8",
                 "--scene-dir", scene_dir, "--shard", "8",
                 "--dynamic-grid-res"], cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 1 and "incompatible" in r.stderr


def test_cli_shard_checkpoint_resume(tmp_path, scene_dir):
    """--checkpoint + --shard N (round-5): the sharded render accumulates
    in checkpointed windows, resumes to the same image, and matches the
    unsharded checkpointed render."""
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ck = str(tmp_path / "film.npz")
    args = ["super", "16", "16", "--spp", "8", "--seed", "5",
            "--scene-dir", scene_dir, "--shard", "4",
            "--checkpoint", ck, "--spp-per-step", "4"]
    r = run_cli(args, cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "checkpointed, 8 spp" in r.stdout
    img1 = pam.load_pam(str(tmp_path / "result.ppm")).data.copy()
    # re-run: resumes (no-op) and writes the same image
    r = run_cli(args, cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_array_equal(
        img1, pam.load_pam(str(tmp_path / "result.ppm")).data)
    # equals the unsharded checkpointed render up to quantisation
    r = run_cli(["super", "16", "16", "--spp", "8", "--seed", "5",
                 "--scene-dir", scene_dir, "--checkpoint",
                 str(tmp_path / "film1.npz"), "--spp-per-step", "4",
                 "--out", "plain.ppm"], cwd=str(tmp_path), extra_env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    img3 = pam.load_pam(str(tmp_path / "plain.ppm")).data
    np.testing.assert_allclose(img1.astype(int), img3.astype(int), atol=1)
