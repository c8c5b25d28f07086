"""The port's model problems, normalizers and demos against the JAX package.

* ``smoothing_problem`` / ``poisson_problem`` (mesh, point cloud,
  bilaplacian) build the same positions, neighbor arrays and LHS, exactly
  (same numpy code);
* three ``ConformalFlow`` steps (f32) give positions within 1e-4 of the
  JAX package's, and the solver keeps one context throughout;
* each demo's ``main`` runs with ``--device cpu`` and writes its output
  where ``--out`` says.
"""

import numpy as np
import pytest
import torch

from gravo_mg_tpu.models import ConformalFlow as RefFlow
from gravo_mg_tpu.models import poisson_problem as ref_poisson
from gravo_mg_tpu.models import smoothing_problem as ref_smoothing
from gravo_mg_tpu.utils import normalize as ref_normalize
from gravo_mg_tpu_torch.models import (
    ConformalFlow,
    poisson_problem,
    smoothing_problem,
)
from gravo_mg_tpu_torch.utils import normalize
from gravo_mg_tpu_torch.utils.meshgen import icosphere, point_cloud

torch.set_num_threads(2)


@pytest.mark.parametrize("which", ["smoothing", "poisson"])
@pytest.mark.parametrize("kw", [
    {},
    {"bilaplacian": True},
    {"pointcloud": True},
    {"normalize": False},
])
def test_problems_match_reference(which, kw):
    V, F = icosphere(3, bump=0.2)
    fn, ref_fn = ((smoothing_problem, ref_smoothing) if which == "smoothing"
                  else (poisson_problem, ref_poisson))
    got, ref = fn(V, F, **kw), ref_fn(V, F, **kw)
    np.testing.assert_array_equal(got.pos, ref.pos)
    np.testing.assert_array_equal(got.neigh, ref.neigh)
    assert (got.faces is None) == (ref.faces is None)
    for a, b in ((got.lhs, ref.lhs), (got.mass, ref.mass),
                 (got.stiffness, ref.stiffness)):
        assert a.shape == b.shape and (a != b).nnz == 0
    b = np.random.default_rng(0).standard_normal((V.shape[0], 2))
    np.testing.assert_array_equal(got.make_rhs(b), ref.make_rhs(b))


def test_normalizers_match_reference():
    V, F = icosphere(2, bump=0.3)
    V = V * np.array([3.0, 1.0, 0.5]) + 2.0
    np.testing.assert_array_equal(normalize.face_area(V, F),
                                  ref_normalize.face_area(V, F))
    np.testing.assert_array_equal(normalize.normalize_area(V, F),
                                  ref_normalize.normalize_area(V, F))
    np.testing.assert_array_equal(normalize.normalize_bounding_box(V),
                                  ref_normalize.normalize_bounding_box(V))
    np.testing.assert_array_equal(normalize.normalize_axes(V),
                                  ref_normalize.normalize_axes(V))
    assert abs(normalize.face_area(normalize.normalize_area(V, F), F).sum()
               - 1.0) < 1e-12


@pytest.mark.parametrize("pointcloud", [False, True])
def test_conformal_flow_matches_reference(pointcloud):
    if pointcloud:
        V, F, kw = point_cloud(2000, seed=3), None, {"lower_bound": 200}
    else:
        V, F = icosphere(3, bump=0.35)
        kw = {"lower_bound": 80}
    flow = ConformalFlow(V, F, tau=5e-3, pointcloud=pointcloud, device="cpu",
                         **kw)
    ref = RefFlow(V, F, tau=5e-3, pointcloud=pointcloud, **kw)
    assert flow.solver.hierarchy.dof == ref.solver.hierarchy.dof
    np.testing.assert_array_equal(flow.V, ref.V)
    ctx = None
    for _ in range(3):
        got, want = flow.step(), ref.step()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-4
        assert len(flow.solver._contexts) == 1
        ctx = ctx or next(iter(flow.solver._contexts.values()))
        assert next(iter(flow.solver._contexts.values())) is ctx
        assert flow.solver.solver_timing["residue"] <= 1e-4


def test_conformal_flow_rounds_the_surface():
    V, F = icosphere(3, bump=0.35)
    flow = ConformalFlow(V, F, tau=5e-3, lower_bound=80, device="cpu")

    def roundness(P):
        r = np.linalg.norm(P - P.mean(axis=0), axis=1)
        return r.std() / r.mean()

    r0 = roundness(flow.V)
    assert roundness(flow.run(4)) < r0


def _write_obj(path, V, F):
    with open(path, "w") as fh:
        for v in V:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in F + 1:
            fh.write(f"f {a} {b} {c}\n")


def test_demos_run_on_cpu(tmp_path, capsys):
    from gravo_mg_tpu_torch.demos import (
        conformal_flow,
        conformal_flow_pointcloud,
        smoothing,
    )

    V, F = icosphere(3, bump=0.2)
    obj = tmp_path / "in.obj"
    _write_obj(obj, V, F)
    Vr, Fr = smoothing.load_or_generate(str(obj))
    np.testing.assert_allclose(Vr, V, rtol=1e-12)
    np.testing.assert_array_equal(Fr, F)

    out = tmp_path / "smoothed.obj"
    smoothing.main(["--input", str(obj), "--out", str(out), "--device", "cpu"])
    Vs, Fs = smoothing.load_or_generate(str(out))
    assert Vs.shape == V.shape and np.isfinite(Vs).all()
    np.testing.assert_array_equal(Fs, F)

    conformal_flow.main(["--input", str(obj), "--steps", "2", "--device", "cpu",
                         "--out", str(tmp_path / "flow")])
    for step in range(2):
        Vf, _ = smoothing.load_or_generate(str(tmp_path / f"flow_{step:03d}.obj"))
        assert Vf.shape == V.shape and np.isfinite(Vf).all()

    conformal_flow_pointcloud.main(["--n", "1500", "--steps", "1", "--device",
                                    "cpu", "--out", str(tmp_path / "pc")])
    P = np.load(tmp_path / "pc_000.npy")
    assert P.shape == (1500, 3) and np.isfinite(P).all()
    assert "cpu" in capsys.readouterr().out


def test_conformal_flow_cuda_default_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    V, F = icosphere(2)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ConformalFlow(V, F)                  # device="cuda" default
