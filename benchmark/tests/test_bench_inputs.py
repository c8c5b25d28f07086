"""The input layer: a configuration's ``mesh.kind`` names the module that
makes its inputs.  Every torus cell's inputs are byte for byte those of the
frozen torus functions called directly (``_direct_inputs``); the point
cloud's frozen copies are the program's functions; a point-cloud
configuration with its ``neighbors`` and ``hierarchy`` keys runs through the
harness with no harness file edited."""

import json

import numpy as np
import pytest

from benchmark import harness, loops
from benchmark.reference import inputs
from benchmark.reference.inputs import point_cloud as pc
from benchmark.reference.mesh import (
    cotan_laplacian,
    mass_barycentric,
    mean_edge_length,
    normalize_area,
    system_matrix,
    torus_mesh,
)
from benchmark.tests.test_bench_faults import Broken
from benchmark.tests.tiny import cut, tiny_root

SEEDS = [5, 2**31 + 7]


def _direct_inputs(cfg, traffic, seed):
    """The torus, its operators and the right-hand sides or the flow's
    start, from the frozen functions and the solve kind's pool arithmetic
    written out."""
    mesh = cfg["mesh"]
    V, F = torus_mesh(mesh["nu"], mesh["nv"], R=mesh.get("R", 1.0),
                      r=mesh.get("r", 0.4))
    if mesh.get("normalize_area", False):
        V = normalize_area(V, F)
    rng = np.random.default_rng(seed)
    if traffic["kind"] == "flow":
        h = mean_edge_length(V, F) * float(traffic["start_jitter"])
        return V, F, None, None, None, [V + h * rng.standard_normal(V.shape)]
    M = mass_barycentric(V, F)
    S = cotan_laplacian(V, F)
    n, size = V.shape[0], int(traffic["pool"])
    if traffic["rhs"] == "mass_randn":
        cols = int(traffic["columns"])
        B = rng.standard_normal((n, cols * size))
        pool = [M @ B[:, i * cols:(i + 1) * cols] for i in range(size)]
    else:
        h = mean_edge_length(V, F) * float(traffic["jitter"])
        pool = [M @ (V + h * rng.standard_normal(V.shape)) for _ in range(size)]
    pool = [np.ascontiguousarray(b[:, 0]) if b.shape[1] == 1 else b for b in pool]
    return V, F, S, M, system_matrix(cfg, S, M), pool


def _layer_inputs(cfg, traffic, seed):
    inp = inputs.make(cfg["mesh"])
    rng = np.random.default_rng(seed)
    if traffic["kind"] == "flow":
        h = inp.h * float(traffic["start_jitter"])
        return (inp.V, inp.F, None, None, None,
                [inp.V + h * rng.standard_normal(inp.V.shape)])
    pool = loops.rhs_pool(traffic, inp, rng)
    return inp.V, inp.F, inp.S, inp.M, system_matrix(cfg, inp.S, inp.M), pool


def _same_bytes(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if hasattr(a, "indptr"):
        return all(_same_bytes(getattr(a, k), getattr(b, k))
                   for k in ("indptr", "indices", "data")) and a.shape == b.shape
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _torus_cells():
    spec = harness.load_spec()
    return [(c["name"], c["config"], c["traffic"]) for c in spec["workloads"]
            if harness.load_config(spec, c["config"])["mesh"]["kind"] == "torus"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,config,traffic", _torus_cells())
def test_the_torus_cells_inputs_are_byte_identical(cell, config, traffic, seed):
    spec = harness.load_spec()
    cfg = harness.load_config(spec, config)
    cut(cfg, nu=48, nv=24)
    t = harness.load_traffic(traffic)
    direct, layer = _direct_inputs(cfg, t, seed), _layer_inputs(cfg, t, seed)
    for name, a, b in zip(("V", "F", "S", "M", "lhs"), direct, layer):
        assert _same_bytes(a, b), name
    assert len(direct[5]) == len(layer[5])
    assert all(_same_bytes(a, b) for a, b in zip(direct[5], layer[5]))


@pytest.mark.parametrize("surface", ["sphere", "torus"])
@pytest.mark.parametrize("order", ["sampled", "morton"])
def test_point_cloud_copies_equal_the_ports_functions(surface, order):
    from gravo_mg_tpu_torch.utils import laplacian, meshgen, morton, neighbors, normalize

    P = pc.point_cloud(2000, seed=3, surface=surface)
    assert _same_bytes(P, meshgen.point_cloud(2000, seed=3, surface=surface))
    V = pc.normalize_bounding_box(P)
    assert _same_bytes(V, normalize.normalize_bounding_box(P))
    perm = pc.morton_order(V)
    assert np.array_equal(perm, morton.morton_order(V))
    if order == "morton":
        V = np.ascontiguousarray(V[perm])
    assert np.array_equal(pc.knn(V, 12), neighbors.knn(V, 12))
    neigh = pc.knn_undirected(V, 12)
    assert _same_bytes(neigh, neighbors.knn_undirected(V, 12))
    for a, b in zip(pc.neighbors_to_edges(neigh), neighbors.neighbors_to_edges(neigh)):
        assert _same_bytes(a, b)
    S, M = pc.point_cloud_laplacian(V, 12)
    S2, M2 = laplacian.point_cloud_laplacian(V, 12)
    assert _same_bytes(S, S2) and _same_bytes(M, M2)
    inp = inputs.make({"kind": "point_cloud", "n": 2000, "seed": 3,
                       "surface": surface, "order": order})
    assert inp.F is None and _same_bytes(inp.V, V) and _same_bytes(inp.S, S)
    C = S.tocoo()
    off = C.row != C.col
    assert inp.h == pytest.approx(
        np.linalg.norm(V[C.row[off]] - V[C.col[off]], axis=1).mean(), rel=1e-12)


def test_an_unknown_kind_names_the_missing_file():
    with pytest.raises(ValueError, match="inputs/cube.py"):
        inputs.make({"kind": "cube"})


CLOUD = {
    "name": "poisson-cloud-tiny",
    "system": "poisson",
    "eta": 1e-6,
    "mesh": {"kind": "point_cloud", "n": 2000, "seed": 3, "surface": "sphere",
             "k": 12, "order": "sampled"},
    "neighbors": "stiffness",
    "hierarchy": {"nested": True, "ratio": 8.0, "sampling_strategy": "FASTDISK",
                  "weighting": "BARYCENTRIC"},
    "solver": {"dtype": "float32", "tolerance": 1e-4, "stopping_criteria": 2,
               "lower_bound": 64, "max_iter": 100, "cycle_type": 0,
               "pre_iters": 4, "post_iters": 4},
    "check": {"solve": {"residual": 2e-4}},
    "control": {"dtype": "bfloat16"},
}


@pytest.fixture(scope="module")
def cloud_root(tmp_path_factory):
    """A tiny root with a point-cloud configuration and its cells added as
    new files and entries only."""
    root, bench = tiny_root(tmp_path_factory.mktemp("cloud"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for order in ("sampled", "morton"):
        cfg = json.loads(json.dumps(CLOUD))
        cfg["name"] = f"cloud-{order}"
        cfg["mesh"]["order"] = order
        (bench / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": cfg["name"], "source": "test",
                                "file": f"benchmark/configs/{cfg['name']}.json",
                                "reduced": ["n"], "why": "test"})
        spec["workloads"].append({"name": f"{cfg['name']}.fused",
                                  "config": cfg["name"], "traffic": "fused",
                                  "chips": 1, "why": "test"})
    spec["workloads"].append({"name": "cloud.flow", "config": "cloud-sampled",
                              "traffic": "flow", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "poisson1m.fused" in m.get("workloads", []):
            m["workloads"] += ["cloud-sampled.fused", "cloud-morton.fused"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench


def _run(cloud_root, cell, system=None):
    root, bench = cloud_root
    return harness.run_cell(cell, 2**31 + 21, 0.3, False, device="cpu",
                            system=system, root=root, bench_dir=bench)


@pytest.mark.parametrize("cell", ["cloud-sampled.fused", "cloud-morton.fused"])
def test_a_point_cloud_configuration_runs_correct(cloud_root, cell):
    r = _run(cloud_root, cell)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert set(r["metrics"]) == {"solves_per_s", "setup_s"}


def test_a_point_cloud_with_an_altered_answer_is_not_correct(cloud_root):
    r = _run(cloud_root, "cloud-sampled.fused", Broken("altered"))
    assert not r["correct"] and r["failed"] > 0, r["check"]


def test_neighbors_and_hierarchy_reach_the_facade():
    from gravo_mg_tpu_torch.enums import Sampling, Weighting
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_stiffness

    cfg = json.loads(json.dumps(CLOUD))
    cfg["hierarchy"].update(sampling_strategy="MIS", weighting="UNIFORM",
                            ratio=6.0)
    inp = inputs.make(cfg["mesh"])
    solve = harness.load_kind("solve")
    solver = loops.Program("cpu").build(solve.program, solve.control, cfg, inp)
    assert solver.nested is True and solver.ratio == 6.0
    assert solver.sampling_strategy is Sampling.MIS
    assert solver.weighting is Weighting.UNIFORM
    assert np.array_equal(solver.neigh, neighbors_from_stiffness(inp.S))
    # without the keys: the faces' 1-ring and the constructor's defaults
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "poisson-torus1m-f32")
    cut(cfg)
    cfg["solver"]["lower_bound"] = 64
    assert loops.solver_kwargs(cfg) == dict(
        lower_bound=64, tolerance=1e-4, stopping_criteria=2, max_iter=100,
        cycle_type=0, pre_iters=4, post_iters=4)
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

    inp = inputs.make(cfg["mesh"])
    assert np.array_equal(loops.neighbors(cfg, inp), neighbors_from_faces(inp.F))


def test_an_unknown_hierarchy_option_or_neighbors_is_refused():
    cfg = json.loads(json.dumps(CLOUD))
    cfg["hierarchy"]["levels"] = 3
    with pytest.raises(ValueError, match="levels"):
        loops.solver_kwargs(cfg)
    inp = inputs.make(CLOUD["mesh"])
    with pytest.raises(ValueError, match="stiffness"):
        loops.neighbors({"neighbors": "faces"}, inp)


def test_the_flow_kind_refuses_a_point_cloud(cloud_root):
    with pytest.raises(ValueError, match="faces"):
        _run(cloud_root, "cloud.flow")
