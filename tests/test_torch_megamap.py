"""Config 5 (parallel/megamap.py): the two-stage refinement against the JAX
reference on the CPU, the restartable refinement (pipeline/checkpoint.py),
the golden fixture the card is held to, and the bench entry.

Tolerances: ``synthesize`` bit for bit (the same numpy code from the same
seed); ``run_megamap`` in f64 1e-9 against JAX's at the same shard count
(the JAX sharded runs on a mesh of the virtual CPU devices); the port's
f32 mid-scale run ATE and landmark RMSE < 0.01 m (the JAX package's
``test_midscale_quality_pin``); a resumed refinement bit for bit.
"""

import collections
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy
from shermbot_navigation_tpu.models import pose_graph as jpg
from shermbot_navigation_tpu.parallel import megamap as jmm
from shermbot_navigation_tpu.parallel import mesh as mesh_lib
from shermbot_navigation_tpu.parallel import schur_dist as jsd
from shermbot_navigation_tpu.pipeline import checkpoint as jcheckpoint
from shermbot_navigation_tpu_torch import bench_megamap
from shermbot_navigation_tpu_torch.models import pose_graph as tpg
from shermbot_navigation_tpu_torch.parallel import megamap as tmm
from shermbot_navigation_tpu_torch.parallel import schur_dist as tsd
from shermbot_navigation_tpu_torch.pipeline import checkpoint
from shermbot_navigation_tpu_torch.utils import convert

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                      "megamap_golden.json")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_synthesize_is_bit_equal_to_jax(dtype):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    want = jmm.synthesize(64, 24, 4, dtype=jdt)
    got = tmm.synthesize(64, 24, 4, dtype=dtype)
    for part in ("truth_poses", "truth_lms", "graph", "bundle"):
        w, g = getattr(want, part), getattr(got, part)
        w = jax_to_numpy(w) if hasattr(w, "_asdict") else {"": w}
        g = g._asdict() if hasattr(g, "_asdict") else {"": g}
        for k, a in w.items():
            b = np.asarray(g[k])
            assert b.dtype == a.dtype, (part, k)
            np.testing.assert_array_equal(b, a, err_msg=f"{part}.{k}")


@pytest.mark.parametrize("n_shards", [1, 4])
def test_run_megamap_matches_jax(n_shards):
    mesh = mesh_lib.make_mesh(jax.devices()[:n_shards], data=1,
                              map_=n_shards)
    kw = dict(pg_iters=8, gn_iters=4, cg_iters=64)
    _, want = jmm.run_megamap(N=64, T=24, obs_per_pose=4, mesh=mesh,
                              dtype=jnp.float64, **kw)
    prob, got = tmm.run_megamap(N=64, T=24, obs_per_pose=4,
                                mesh=n_shards, dtype=torch.float64,
                                device="cpu", **kw)
    for k in ("poses", "landmarks"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=0,
                                   atol=1e-9, err_msg=k)
    # the two stages reduce the drift (the JAX test's bounds)
    truth = prob.truth_poses[:, 1:]
    e = [np.sqrt(np.mean(np.sum((p[:, 1:] - truth) ** 2, -1)))
         for p in (prob.graph.poses, got.poses.numpy())]
    assert e[1] < 0.5 * e[0]
    lm = np.sqrt(np.mean(np.sum((got.landmarks.numpy() - prob.truth_lms)
                                ** 2, -1)))
    assert lm < 0.05


def test_midscale_f32_quality_pin():
    """The port's f32 run at mid scale lands near the measurement-noise
    floor (mm): catches regressions in the gauge projection, the stage
    handoff and GN convergence that tiny shapes cannot see."""
    prob, out = tmm.run_megamap(N=512, T=96, obs_per_pose=6, gn_iters=4,
                                device="cpu")
    assert out.poses.dtype == torch.float32
    ate, lm = bench_megamap.rms_errors(prob, out)
    assert ate < 0.01 and lm < 0.01, (ate, lm)


def _resume_setup():
    prob = tmm.synthesize(64, 24, 4)
    g = tpg.optimize_host(prob.graph, iters=3)
    part = tsd.partition_problem(prob.bundle._replace(poses=g.poses), 2)
    step = tsd.make_sharded_gn(2, T=24, N=64, M=part.obs_t.shape[0],
                               cg_iters=20, gn_steps=2, device="cpu")
    return part, step


def test_refinement_checkpoint_resume(tmp_path):
    """Config 5's refinement is restartable: 2 GN steps, save, load, 2
    more is bit for bit 4 steps straight (the JAX package's test, on two
    map shards)."""
    part, step = _resume_setup()
    full = step(step(part))
    half = step(part)
    path = str(tmp_path / "bundle.npz")
    checkpoint.save(path, half, step=2)
    restored, saved_step = checkpoint.load(path, half)
    assert saved_step == 2
    assert all(a.device == b.device and a.dtype == b.dtype
               for a, b in zip(restored, half))
    resumed = step(restored)
    assert torch.equal(full.poses, resumed.poses)
    assert torch.equal(full.landmarks, resumed.landmarks)


@pytest.mark.parametrize("change", ["structure", "shape", "dtype"])
def test_checkpoint_load_refuses_a_template_that_differs(tmp_path, change):
    part, _ = _resume_setup()
    path = str(tmp_path / "bundle.npz")
    checkpoint.save(path, part)
    like = {"structure": tpg.PoseGraph(*part[:6]),
            "shape": part._replace(poses=part.poses[:-1]),
            "dtype": part._replace(obs_w=part.obs_w.double())}[change]
    with pytest.raises(ValueError, match=change if change != "structure"
                       else "leaves"):
        checkpoint.load(path, like)
    renamed = collections.namedtuple(
        "Renamed", ("pose",) + part._fields[1:])(*part)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.load(path, renamed)


def test_checkpoint_reads_the_jax_packages_file(tmp_path):
    """Leaf names are the JAX package's: a JAX checkpoint of a bundle loads
    into the port's template with the same bits and step, and back."""
    jpart = jsd.partition_problem(jmm.synthesize(64, 24, 4).bundle, 2)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jpart, step=7)
    like = convert.bundle_from_numpy(jax_to_numpy(jpart), "cpu")
    got, step = checkpoint.load(path, like)
    assert step == 7
    for k, w in jax_to_numpy(jpart).items():
        np.testing.assert_array_equal(getattr(got, k).numpy(), w, err_msg=k)
    path2 = str(tmp_path / "port.npz")
    checkpoint.save(path2, got)
    back, none = jcheckpoint.load(path2, jpart)
    assert none is None
    for k, w in jax_to_numpy(jpart).items():
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), w)


def test_run_megamap_without_a_device_means_the_card(monkeypatch):
    """No fallback that hides the card: without one, ``run_megamap()``
    and the sharded step raise, naming ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmm.run_megamap(N=64, T=24, obs_per_pose=4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsd.make_sharded_gn(1, T=24, N=64, M=288)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench_megamap.main(["--N", "64", "--T", "24"])


def _golden_array(entry, key, dtype, shape):
    import base64
    return np.frombuffer(base64.b64decode(entry[key]),
                         np.dtype(dtype).newbyteorder("<")).reshape(shape)


def test_golden_fixture_meets_the_jax_pins():
    """``tests/fixtures/megamap_golden.json`` (JAX, full size, CPU): the
    JAX package's full-scale pins (ATE < 0.13 m, landmark RMSE < 0.15 m),
    f32 within 1e-3 m of f64, and its arrays decode to the config's
    shapes. The run itself is not repeated here."""
    with open(GOLDEN) as f:
        gold = json.load(f)
    c = gold["config"]
    assert (c["N"], c["T"], c["obs_per_pose"], c["gn_iters"],
            c["cg_iters"]) == (50000, 512, 97, 12, 64)
    assert gold["observations"] == 3 * c["T"] * c["obs_per_pose"]
    n_lm = -(-c["N"] // gold["landmark_stride"])
    for name, dt in (("f32", np.float32), ("f64", np.float64)):
        e = gold[name]
        assert e["ate_m"] < 0.13 and e["landmark_rmse_m"] < 0.15, name
        for key, shape in (("stage1_poses_b64", (c["T"], 3)),
                           ("poses_b64", (c["T"], 3)),
                           ("landmarks_strided_b64", (n_lm, 2))):
            assert np.isfinite(_golden_array(e, key, dt, shape)).all()
    assert abs(gold["f32"]["ate_m"] - gold["f64"]["ate_m"]) < 1e-3


def test_bench_entry_prints_the_jax_benchs_keys(capsys):
    """On the CPU only as a check of the entry (small size)."""
    bench_megamap.main(["--N", "256", "--T", "48", "--gn", "2", "--cg", "8",
                        "--shards", "2", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"metric", "N_landmarks", "keyframes", "observations", "gn_steps",
            "cg_iters", "end_to_end_s", "posegraph_5iters_s", "partition_s",
            "schur_stage2_s", "schur_gn_step_s", "refined_pose_ate_m",
            "refined_landmark_rmse_m", "synthesize_s"}
    assert keys <= set(row)
    assert row["device"] == "cpu" and row["execution"] == "eager"
    # observation slots: 3 sightings of 48 x 5 (--obs 2N//T//2), padded
    # to two equal shards
    assert row["observations"] >= 3 * 48 * 5 and row["N_landmarks"] == 256
    assert row["observations"] % 2 == 0
    assert np.isfinite(row["refined_pose_ate_m"])


def test_stage_one_poses_equal_jax_optimize_host():
    """The handoff between the stages: the port's stage-1 poses (host f64,
    cast to f32) are the JAX package's bits."""
    g = jmm.synthesize(128, 32, 4).graph
    want = jpg.optimize_host(g, iters=5).poses
    got = tpg.optimize_host(tmm.synthesize(128, 32, 4).graph, iters=5).poses
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
