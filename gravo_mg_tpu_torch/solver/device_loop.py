"""A step function captured once as a CUDA graph and replayed.

The port's counterpart of ``jax.jit`` around a ``lax.while_loop`` (the
JAX package's ``fused_solve`` in ``gravo_mg_tpu/solver/multigrid.py`` and
its chunked CG in ``gravo_mg_tpu/solver/direct.py``): the loop's body is
a step that reads and writes tensors which outlive it, a masked multigrid
cycle or 32 CG iterations, and :class:`StepGraph` runs it on the card as
one graph launch, so the host launches no kernel per step.  The host
loop around it decides how often to read a stop flag.

A step must not make the host wait for the card: no ``float()``,
``.item()``, ``.cpu()``, boolean-mask indexing, ``torch.nonzero`` or
``repeat_interleave`` without ``output_size``, and no numpy.  Such a call
inside the capture fails it, and :meth:`StepGraph.run` raises.  Python
floats the step reads (the Chebyshev coefficients, ``lam_max``) are baked
into the captured kernels, and so are the addresses of every tensor it
touches: a caller whose operators change drops its graphs.
"""

from __future__ import annotations

import time

import torch

from ..ops import diag_spmv, halo_spmv, shuffle_spmv, sliced_diag_spmv, sliced_spmv

# The wrappers that count their kernel launches (``launches``).
KERNEL_MODULES = (sliced_spmv, sliced_diag_spmv, halo_spmv, diag_spmv, shuffle_spmv)


class StepGraph:
    """Run ``step()`` (no arguments, no result) ``n`` times per :meth:`run`.

    On the card, the first step runs eagerly on the capture stream.  It
    is a real step, and it warms the step up outside any capture: the
    kernel library is built and loaded, cuBLAS creates its workspace for
    that stream.  The first replay that is needed captures the step
    into ``pool`` (one memory pool per owner,
    ``torch.cuda.graph_pool_handle()``); every later step is a replay,
    back to back on the current stream.  A capture or replay that fails
    raises: nothing falls back to an eager loop.  On the CPU every step
    runs eagerly.

    The SpMV wrappers count a launch where they record it into the
    graph.  Those counts are taken back after the capture, which runs
    nothing, and each replay adds them again, so ``ops.*.launches``
    count what ran on the card.
    """

    def __init__(self, step, device, pool=None):
        self.step = step
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.warm = False
        self.captures = 0
        self.replays = 0
        self.capture_ms = 0.0
        self.pool_mib = 0.0     # device memory reserved by the capture
        self._stream = None
        self._per_replay = ()   # (module, launches per replay)

    def run(self, n: int) -> None:
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
        try:
            for _ in range(n):
                self.graph.replay()
        except RuntimeError as exc:
            raise RuntimeError("StepGraph: replay of the captured step failed") from exc
        self.replays += n
        for mod, k in self._per_replay:
            mod.launches += k * n

    def _warm_up(self) -> None:
        self._stream = torch.cuda.Stream(self.device)
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
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        reserved = torch.cuda.memory_reserved(self.device)
        before = [mod.launches for mod in KERNEL_MODULES]
        graph = torch.cuda.CUDAGraph()
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
            recorded = [mod.launches - b for mod, b in zip(KERNEL_MODULES, before)]
            for mod, b in zip(KERNEL_MODULES, before):
                mod.launches = b
        self._per_replay = tuple((m, k) for m, k in zip(KERNEL_MODULES, recorded) if k)
        self.graph = graph
        self.captures += 1
        self.pool_mib = (torch.cuda.memory_reserved(self.device) - reserved) / 2**20
        self.capture_ms = (time.perf_counter() - t0) * 1000

    def release(self) -> None:
        """Drop the graph and its hold on the memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
