"""A step function captured once as a CUDA graph, replayed or looped on
the card.

The port's counterpart of ``jax.jit`` around a ``lax.while_loop`` (the
JAX package's ``fused_solve`` in ``gravo_mg_tpu/solver/multigrid.py`` and
its chunked CG in ``gravo_mg_tpu/solver/direct.py``): the loop's body is
a step that reads and writes tensors which outlive it, a multigrid cycle
or 32 CG iterations.  :class:`StepGraph` runs it on the card in two ways:

* :meth:`StepGraph.run` replays the captured step ``n`` times (CG's unit,
  whose host checks its residual between units, as the JAX ``cg_solve``
  does between chunks);
* :meth:`StepGraph.loop` runs the step while a flag in device memory
  holds, as one launch of a graph with a conditional WHILE node around
  the captured step (``csrc/graph_loop.cu``): the stop test runs on the
  card and the host waits once, at the end, as JAX's ``while_loop`` does.

A step must not make the host wait for the card: no ``float()``,
``.item()``, ``.cpu()``, boolean-mask indexing, ``torch.nonzero`` or
``repeat_interleave`` without ``output_size``, and no numpy.  Such a call
inside the capture fails it, and the caller gets the error.  Python
floats the step reads (the Chebyshev coefficients, ``lam_max``) are baked
into the captured kernels, and so are the addresses of every tensor it
touches: a caller whose operators change drops its graphs.
"""

from __future__ import annotations

import ctypes
import time

import torch

from ..ops import diag_spmv, halo_spmv, shuffle_spmv, sliced_diag_spmv, sliced_spmv
from ..ops.build import check, load_library

# The wrappers that count their kernel launches (``launches``, and per
# epilogue ``launches_by_mode`` where the kernel has epilogues).
KERNEL_MODULES = (sliced_spmv, sliced_diag_spmv, halo_spmv, diag_spmv, shuffle_spmv)


def _counts() -> list:
    """Every kernel module's launches and its per-epilogue counts."""
    return [(mod.launches, dict(getattr(mod, "launches_by_mode", {})))
            for mod in KERNEL_MODULES]

# cudaGraphNodeType, by value
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semaphore_signal", "ext_semaphore_wait",
              "mem_alloc", "mem_free", "batch_memop", "conditional")
# One side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace (32 MiB on an H100) for each stream it has run on, for the
# life of the process, so a stream per StepGraph would leak one workspace
# per graph a flow recaptures after each LHS update.
_CAPTURE_STREAMS: dict = {}
# StepGraphs finalized while a capture is under way (the cyclic garbage
# collector may run at any allocation inside a step): destroying a graph
# then would invalidate that capture, so they wait here and are released
# when it ends.
_DEFERRED: list = []
_BUILD_STAGES = ("", "the conditional handle", "the first control node",
                 "the WHILE node", "the step's child graph", "the body's control node",
                 "instantiation")


def node_types(raw_graph: int) -> dict:
    """Nodes of a ``cudaGraph_t`` by type, those inside child graphs
    included (a child-graph node counts as ``graph``)."""
    lib = load_library()
    counts = (ctypes.c_int64 * 16)()
    check(lib, lib.gravomg_graph_node_types(ctypes.c_void_p(raw_graph), counts),
          "StepGraph: listing the step's nodes")
    return {NODE_TYPES[t] if t < len(NODE_TYPES) else str(t): int(c)
            for t, c in enumerate(counts) if c}


class StepGraph:
    """Run ``step()`` (no arguments, no result) on the card from one capture.

    On the card, the first step runs eagerly on the capture stream.  It
    is a real step, and it warms the step up outside any capture: the
    kernel library is built and loaded, cuBLAS creates its workspace for
    that stream, NCCL its communicators.  The next step that is needed
    captures the step into ``pool`` (one memory pool per owner,
    ``torch.cuda.graph_pool_handle()``); every later step runs from the
    capture.  A capture, build or launch that fails raises: nothing falls
    back to an eager loop.  On the CPU every step runs eagerly.

    The SpMV wrappers count a launch where they record it into the
    graph.  Those counts are taken back after the capture, which runs
    nothing, and added again for every step the card runs from the graph,
    so ``ops.*.launches`` (and ``launches_by_mode``) count what ran on
    the card.
    """

    def __init__(self, step, device, pool=None):
        self.step = step
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None       # torch.cuda.CUDAGraph(keep_graph=True)
        self.warm = False
        self.captures = 0
        self.builds = 0         # loop(): WHILE graphs built
        self.replays = 0        # run(): replays of the captured step
        self.launches = 0       # loop(): launches of the WHILE graph
        self.bodies = 0         # loop(): steps run inside those launches
        self.capture_ms = 0.0
        self.build_ms = 0.0     # loop(): building and instantiating the WHILE graph
        self.pool_mib = 0.0     # device memory reserved by the capture
        self.step_nodes: dict = {}   # the captured step's nodes by type
        self._stream = None
        self._per_replay = ()   # (module, launches per step)
        self._loop = None       # (exec, graph) of the WHILE graph

    def run(self, n: int) -> None:
        """Run the step ``n`` times: replays of the captured step."""
        if n <= 0:
            return
        if self.device.type != "cuda":
            for _ in range(n):
                self.step()
            return
        if not self.warm:
            self._warm_up()
            n -= 1
            if n == 0:
                return
        if self.graph is None:
            self._capture()
            self.graph.instantiate()
        try:
            for _ in range(n):
                self.graph.replay()
        except RuntimeError as exc:
            raise RuntimeError("StepGraph: replay of the captured step failed") from exc
        self.replays += n
        self._count(n)

    def loop(self, flag: torch.Tensor, counter: torch.Tensor):
        """Run the step while ``flag`` holds: the JAX ``while_loop`` with
        the step as its body and ``flag`` as its cond.

        ``flag`` is a 0-d bool tensor that the caller has set true and
        that every step rewrites; ``counter`` a 0-d integer tensor that the
        caller has set to 0 and that every step adds one to.  Returns
        ``(steps, host reads)``: ``steps`` is the counter at the end,
        read in the one host wait after the loop.  On the card a loop is
        one launch of the WHILE graph, which keeps the address of the
        ``flag`` it was built for; a cold graph first runs one step
        eagerly and reads the flag once, then captures and builds.  On
        the CPU the host reads the flag after every step.
        """
        if self.device.type != "cuda":
            reads = 0
            while True:
                self.step()
                reads += 1
                if not bool(flag):
                    return int(counter), reads + 1
        eager = reads = 0
        if not self.warm:
            self._warm_up()
            eager = reads = 1
            if not bool(flag):
                return int(counter), reads + 1
        if self._loop is None:
            if self.graph is None:
                self._capture()
            self._build(flag)
        lib = load_library()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        check(lib, lib.gravomg_graph_loop_launch(ctypes.c_void_p(self._loop[0]),
                                                 ctypes.c_void_p(stream)),
              "StepGraph: launching the WHILE graph")
        self.launches += 1
        steps = int(counter)
        self.bodies += steps - eager
        self._count(steps - eager)
        return steps, reads + 1

    def _count(self, steps: int) -> None:
        for mod, k, by_mode in self._per_replay:
            mod.launches += k * steps
            for mode, km in by_mode.items():
                mod.launches_by_mode[mode] += km * steps

    def _warm_up(self) -> None:
        index = self.device.index
        if index is None:
            index = torch.cuda.current_device()
        if index not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
        self._stream = _CAPTURE_STREAMS[index]
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            self.step()
        current.wait_stream(self._stream)
        self.warm = True

    def _capture(self) -> None:
        # capture_begin/capture_end, not the torch.cuda.graph context: that
        # one runs gc.collect() and empty_cache() first, which CG would pay
        # on every call.  A private pool takes no cached block of the
        # general one, so the reserved bytes it adds are the graph's.
        # keep_graph: the cudaGraph_t stays, for the WHILE graph's body.
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        before = _counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self.pool)
                try:
                    self.step()
                finally:
                    graph.capture_end()
        except RuntimeError as exc:
            raise RuntimeError(
                "StepGraph: capturing the step failed (a step must not make "
                "the host wait for the card)") from exc
        finally:
            while _DEFERRED:
                _DEFERRED.pop().release()
            recorded = [(n - b, {m: c - bm.get(m, 0) for m, c in modes.items()})
                        for (n, modes), (b, bm) in zip(_counts(), before)]
            for mod, (b, bm) in zip(KERNEL_MODULES, before):
                mod.launches = b
                if bm:
                    mod.launches_by_mode.update(bm)
        self._per_replay = tuple((mod, k, {m: c for m, c in by_mode.items() if c})
                                 for mod, (k, by_mode) in zip(KERNEL_MODULES, recorded)
                                 if k)
        self.graph = graph
        self.captures += 1
        self.pool_mib = (torch.cuda.memory_reserved(self.device) - reserved) / 2**20
        self.capture_ms = (time.perf_counter() - t0) * 1000

    def _build(self, flag: torch.Tensor) -> None:
        """The WHILE graph around the captured step (``csrc/graph_loop.cu``),
        instantiated.  It holds a copy of the step, whose buffers stay in
        ``self.graph``'s pool until :meth:`release`."""
        t0 = time.perf_counter()
        lib = load_library()
        raw = self.graph.raw_cuda_graph()
        self.step_nodes = node_types(raw)
        exec_, graph = ctypes.c_void_p(), ctypes.c_void_p()
        stage = (ctypes.c_int64 * 3)()
        err = lib.gravomg_graph_loop_create(
            ctypes.c_void_p(raw), ctypes.c_void_p(flag.data_ptr()),
            ctypes.byref(exec_), ctypes.byref(graph), stage)
        if err != 0:
            blamed = (NODE_TYPES[stage[2]] if 0 <= stage[2] < len(NODE_TYPES)
                      else "none")
            raise RuntimeError(
                f"StepGraph: building the WHILE graph failed at "
                f"{_BUILD_STAGES[stage[0]]}: CUDA error {err} "
                f"({lib.gravomg_cuda_error_string(err).decode()}); "
                f"instantiation result {stage[1]}, node blamed: {blamed}; "
                f"the step's nodes by type: {self.step_nodes}")
        self._loop = (exec_.value, graph.value)
        self.builds += 1
        self.build_ms = (time.perf_counter() - t0) * 1000

    def release(self) -> None:
        """Free the WHILE graph, then drop the captured step and its hold
        on the memory pool."""
        if self._loop is not None:
            lib = load_library()
            err = lib.gravomg_graph_loop_destroy(ctypes.c_void_p(self._loop[0]),
                                                 ctypes.c_void_p(self._loop[1]))
            self._loop = None
            check(lib, err, "StepGraph: destroying the WHILE graph")
        if self.graph is not None:
            self.graph.reset()
        self.graph = None

    def __del__(self):
        # an owner dropped without release(): free the native graph too,
        # after the capture under way if there is one
        if self._loop is None and self.graph is None:
            return
        try:
            if torch.cuda.is_current_stream_capturing():
                _DEFERRED.append(self)
                return
            self.release()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
