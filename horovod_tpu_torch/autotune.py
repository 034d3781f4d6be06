"""Autotuning of the gradient allreduce.

Port of ``horovod_tpu/autotune.py`` (itself a rebuild of upstream
``horovod/common/controller.cc``'s autotune hooks and
``horovod/runner/autotune``): the fusion threshold, and optionally the cast
compression, the allreduce algorithm and its chunk count, and the wire
precision, tuned against observed step times. :class:`Autotuner` walks a
ladder of thresholds; :class:`BayesianAutotuner` fits a Gaussian process
(pure numpy) and probes by expected improvement. ``DistributedOptimizer``
feeds one of them one record per ``synchronize`` under
``HOROVOD_AUTOTUNE`` (``optimizer.py``). Upstream's cycle time has no
counterpart: the port has no background cycle either.

The reference's ``autotune_flash_blocks`` tunes the Pallas kernels' block
sizes; the port's CUDA kernels fix their tiles at compile time, so it is
not ported (ROADMAP.md section A).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["AutotuneResult", "autotune_fusion_threshold", "Autotuner",
           "BayesianAutotuner"]

_MB = 1024 * 1024


@dataclass
class AutotuneResult:
    best_threshold_bytes: int
    # threshold -> seconds a step
    trials: Dict[int, float] = field(default_factory=dict)

    def summary(self) -> str:
        lines = ["best fusion threshold: "
                 f"{self.best_threshold_bytes / _MB:.1f} MB"]
        for t, s in sorted(self.trials.items()):
            lines.append(f"  {t / _MB:8.1f} MB -> {s * 1e3:8.2f} ms/step")
        return "\n".join(lines)


def autotune_fusion_threshold(
        step_factory: Callable[[int], Callable[[], None]],
        candidates_bytes: Optional[List[int]] = None,
        steps_per_trial: int = 5,
        warmup_steps: int = 2) -> AutotuneResult:
    """Measure ``step_factory(threshold)()`` across candidate thresholds.

    ``step_factory`` builds a zero-arg step closure for a given
    fusion threshold; each candidate is warmed up then timed (the
    closure must wait for the device itself).
    """
    if candidates_bytes is None:
        candidates_bytes = [1 * _MB, 4 * _MB, 16 * _MB, 64 * _MB, 256 * _MB]
    trials: Dict[int, float] = {}
    for thr in candidates_bytes:
        step = step_factory(thr)
        for _ in range(warmup_steps):
            step()
        t0 = time.perf_counter()
        for _ in range(steps_per_trial):
            step()
        trials[thr] = (time.perf_counter() - t0) / steps_per_trial
    best = min(trials, key=trials.get)
    return AutotuneResult(best_threshold_bytes=best, trials=trials)


class Autotuner:
    """Online variant mirroring the reference's in-training autotune: feed it
    per-step timings via ``record``, and it proposes the next threshold to
    try until converged."""

    def __init__(self, candidates_bytes: Optional[List[int]] = None,
                 samples_per_candidate: int = 10):
        self._candidates = list(candidates_bytes or
                                [1 * _MB, 4 * _MB, 16 * _MB, 64 * _MB,
                                 256 * _MB])
        self._samples = samples_per_candidate
        self._timings: Dict[int, List[float]] = {
            c: [] for c in self._candidates}
        self._idx = 0
        self._best: Optional[int] = None

    @property
    def converged(self) -> bool:
        return self._best is not None

    def current_threshold(self) -> int:
        if self._best is not None:
            return self._best
        return self._candidates[self._idx]

    def record(self, step_seconds: float) -> None:
        if self._best is not None:
            return
        # Lazy: autotune stays importable without pulling the package in.
        from horovod_tpu_torch.metrics import event, gauge, registry
        registry.counter("autotune_samples_total").inc()
        cur = self._candidates[self._idx]
        self._timings[cur].append(step_seconds)
        if len(self._timings[cur]) >= self._samples:
            self._idx += 1
            if self._idx >= len(self._candidates):
                med = {c: sorted(v)[len(v) // 2]
                       for c, v in self._timings.items() if v}
                self._best = min(med, key=med.get)
                gauge("autotune_threshold_bytes").set(self._best)
                event("autotune_converged", mode="ladder",
                      threshold_bytes=self._best)
            else:
                event("autotune_probe", mode="ladder",
                      threshold_bytes=self._candidates[self._idx])


class BayesianAutotuner:
    """GP-guided online fusion tuning (upstream ``horovod/runner/autotune``).

    Upstream tunes HOROVOD_FUSION_THRESHOLD / HOROVOD_CYCLE_TIME with a
    Gaussian-process Bayesian optimizer scored by observed throughput
    (``horovod/runner/autotune``: spectral-mixture GP + expected
    improvement). This is the equivalent over the knobs that
    exist here: the fusion threshold (continuous, log₂ space) and
    optionally the wire compression (categorical, one-hot GP coordinates —
    the standard mixed-space embedding). Cycle time has no counterpart
    (no background cycle; see module docstring).

    Drop-in for :class:`Autotuner` where it is consumed
    (``DistributedOptimizer.synchronize``): same
    ``record(step_seconds)`` / ``current_threshold()`` / ``converged``
    surface, same deterministic convergence step count on every process
    (fixed probes × samples). One multi-process difference from the
    ladder: GP proposals are computed from *local* step timings, so after
    each probe the next point must be agreed across processes before it
    feeds any collective's signature — ``pending_sync`` flips True at
    every probe boundary and the consumer broadcasts rank 0's
    ``current_point()`` into ``set_current_point()`` on the others
    (upstream runs the whole Bayesian tuner in the coordinator and ships
    proposals to workers for the same reason). The ladder's fixed
    candidate walk never needed this.

    Why a GP *here* when ``autotune_fusion_threshold``'s docstring argues
    grid-walks beat one for a 1-D sweep: the online setting pays real
    training steps per sample, and with compression enabled the space is
    1-D × categorical — the GP typically lands within noise of the best
    knob in ~6 probes where the ladder spends 5 probes per *dimension
    level*. The GP is a ~60-line pure-numpy RBF posterior; no deps.
    """

    #: categorical compression levels, in one-hot embedding order
    COMPRESSION_CHOICES = ("none", "fp16")
    #: allreduce algorithm axis (overlap.py), in embedding order — "auto"
    #: is excluded: the tuner's whole job is to beat the heuristic.
    ALGORITHM_CHOICES = ("psum", "rs_ag", "chunked_rs_ag")
    #: chunk-count rungs for chunked_rs_ag (log2-embedded)
    CHUNK_CHOICES = (1, 2, 4, 8)
    #: wire-precision axis (overlap.WIRES order): the payload format the
    #: RS+AG decomposition puts on the wire per bucket — fp32 (exact),
    #: bf16 cast, or the block-quantized 1-byte formats.
    WIRE_CHOICES = ("fp32", "bf16", "int8", "fp8")
    #: topology-schedule axis: how the picked algorithm maps onto the
    #: fabric — the flat 1-D ring, the multi-phase torus decomposition
    #: ("2d" upgrades rs_ag-family picks to their _2d forms), or the
    #: distance-halving swing schedule (replaces the pick outright; exact
    #: wire only). Folded into ``current_algorithm()``'s returned name,
    #: so a consumer passes one algorithm string.
    TOPOLOGY_CHOICES = ("ring", "2d", "swing")

    def __init__(self, lo_bytes: int = _MB, hi_bytes: int = 256 * _MB,
                 probes: int = 6, samples_per_probe: int = 10,
                 tune_compression: bool = False,
                 tune_algorithm: bool = False,
                 tune_wire: bool = False,
                 tune_topology: bool = False):
        import math
        self._lo = math.log2(lo_bytes)
        self._hi = math.log2(hi_bytes)
        self._probes = probes
        self._samples = samples_per_probe
        self._tune_comp = tune_compression
        self._tune_alg = tune_algorithm
        self._tune_wire = tune_wire
        self._tune_topology = tune_topology
        # (normalized threshold coord, compression index, algorithm
        # index, chunk index, wire index, topology index) per probe
        self._xs: List[tuple] = []
        self._ys: List[float] = []   # median step seconds per probe
        self._pending: List[float] = []
        self._cur = self._next_point()
        self._best: Optional[int] = None
        self._best_compression: Optional[str] = None
        self._best_algorithm: Optional[str] = None
        self._best_chunks: Optional[int] = None
        self._best_wire: Optional[str] = None
        self._best_topology: Optional[str] = None
        #: True whenever a fresh GP proposal is live and has not yet been
        #: agreed across processes (see class docstring). The first point
        #: is fixed, so no sync is needed until a probe completes.
        self.pending_sync = False

    # -- the Autotuner drop-in surface ------------------------------------
    @property
    def converged(self) -> bool:
        return self._best is not None

    def current_threshold(self) -> int:
        if self._best is not None:
            return self._best
        return self._denorm(self._cur[0])

    def current_compression(self) -> str:
        """Current compression pick ("none" unless ``tune_compression``)."""
        if self._best_compression is not None:
            return self._best_compression
        return self.COMPRESSION_CHOICES[self._cur[1]]

    def current_algorithm(self) -> str:
        """Current allreduce-algorithm pick ("auto" — i.e. the size
        heuristic — unless ``tune_algorithm``). With ``tune_topology``
        the topology schedule is folded into the name (``rs_ag`` +
        ``"2d"`` -> ``"rs_ag_2d"``, any pick + ``"swing"`` ->
        ``"swing"``), so consumers keep passing a single algorithm
        string."""
        if not self._tune_alg:
            return "auto"
        alg = (self._best_algorithm if self._best_algorithm is not None
               else self.ALGORITHM_CHOICES[self._cur[2]])
        return self._compose_topology(alg)

    def current_topology(self) -> str:
        """Current topology-schedule pick ("ring" unless
        ``tune_topology``)."""
        if not self._tune_topology:
            return "ring"
        if self._best_topology is not None:
            return self._best_topology
        return self.TOPOLOGY_CHOICES[self._cur[5]]

    def _compose_topology(self, alg: str) -> str:
        """Fold the topology pick into an algorithm name (idempotent —
        an already-composed name from a peer's broadcast passes
        through)."""
        if not self._tune_topology or alg.endswith("_2d") or alg == "swing":
            return alg
        topo = self.current_topology()
        if topo == "swing":
            return "swing"
        if topo == "2d" and alg in ("rs_ag", "chunked_rs_ag"):
            return alg + "_2d"
        return alg

    def current_chunks(self) -> int:
        """Current chunked_rs_ag pipeline depth (the config default when
        algorithm tuning is off)."""
        if not self._tune_alg:
            from horovod_tpu_torch.config import get_config
            return get_config().overlap_chunks
        if self._best_chunks is not None:
            return self._best_chunks
        return self.CHUNK_CHOICES[self._cur[3]]

    def current_wire(self) -> str:
        """Current wire-precision pick (the config wire when wire tuning
        is off). Compose with the algorithm via
        ``overlap.compose_algorithm(current_algorithm(), current_wire())``
        — psum picks stay exact by construction."""
        if not self._tune_wire:
            from horovod_tpu_torch.config import get_config
            return get_config().allreduce_wire
        if self._best_wire is not None:
            return self._best_wire
        return self.WIRE_CHOICES[self._cur[4]]

    def record(self, step_seconds: float) -> None:
        if self._best is not None:
            return
        from horovod_tpu_torch.metrics import event, gauge, registry
        registry.counter("autotune_samples_total").inc()
        self._pending.append(step_seconds)
        if len(self._pending) < self._samples:
            return
        med = sorted(self._pending)[len(self._pending) // 2]
        self._pending = []
        self._xs.append(self._cur)
        self._ys.append(med)
        if len(self._xs) >= self._probes:
            i = min(range(len(self._ys)), key=self._ys.__getitem__)
            self._best = self._denorm(self._xs[i][0])
            self._best_compression = self.COMPRESSION_CHOICES[self._xs[i][1]]
            if self._tune_alg:
                self._best_algorithm = self.ALGORITHM_CHOICES[self._xs[i][2]]
                self._best_chunks = self.CHUNK_CHOICES[self._xs[i][3]]
            if self._tune_wire:
                self._best_wire = self.WIRE_CHOICES[self._xs[i][4]]
            if self._tune_topology:
                self._best_topology = self.TOPOLOGY_CHOICES[self._xs[i][5]]
            gauge("autotune_threshold_bytes").set(self._best)
            event("autotune_converged", mode="bayes",
                  threshold_bytes=self._best,
                  compression=self._best_compression,
                  algorithm=self.current_algorithm(),
                  chunks=self.current_chunks() if self._tune_alg else None,
                  wire=self.current_wire() if self._tune_wire else None,
                  topology=(self._best_topology
                            if self._tune_topology else None))
        else:
            self._cur = self._next_point()
            # points 2-3 of the initial design are timing-independent and
            # identical everywhere; GP proposals (probe 4+) are not
            self.pending_sync = len(self._xs) >= 3
            event("autotune_probe", mode="bayes",
                  threshold_bytes=self._denorm(self._cur[0]),
                  compression=self.COMPRESSION_CHOICES[self._cur[1]],
                  algorithm=(self.ALGORITHM_CHOICES[self._cur[2]]
                             if self._tune_alg else "auto"),
                  wire=(self.WIRE_CHOICES[self._cur[4]]
                        if self._tune_wire else None),
                  topology=(self.TOPOLOGY_CHOICES[self._cur[5]]
                            if self._tune_topology else None),
                  median_step_s=round(med, 6))

    def current_point(self) -> tuple:
        """The live probe point, for cross-process agreement (rank 0
        broadcasts this; others feed it to :meth:`set_current_point`)."""
        return self._cur

    def set_current_point(self, point) -> None:
        point = tuple(point)
        if len(point) < 6:             # legacy shorter points: keep the
            point = point + self._cur[len(point):]   # local trailing axes
        x01, comp, alg, chunk, wire, topo = point
        self._cur = (float(x01), int(comp), int(alg), int(chunk),
                     int(wire), int(topo))
        self.pending_sync = False

    def summary(self) -> str:
        lines = [f"bayesian autotune: {len(self._xs)} probes"]
        for (x, c, a, ch, w, t), y in zip(self._xs, self._ys):
            alg = (f" {self.ALGORITHM_CHOICES[a]}x{self.CHUNK_CHOICES[ch]}"
                   if self._tune_alg else "")
            wire = (f" wire={self.WIRE_CHOICES[w]}"
                    if self._tune_wire else "")
            topo = (f" topo={self.TOPOLOGY_CHOICES[t]}"
                    if self._tune_topology else "")
            lines.append(f"  {self._denorm(x) / _MB:8.1f} MB "
                         f"{self.COMPRESSION_CHOICES[c]:5s}{alg}{wire}"
                         f"{topo} -> {y * 1e3:8.2f} ms/step")
        if self._best is not None:
            alg = (f" {self._best_algorithm}x{self._best_chunks}"
                   if self._tune_alg else "")
            wire = (f" wire={self._best_wire}" if self._tune_wire else "")
            topo = (f" topo={self._best_topology}"
                    if self._tune_topology else "")
            lines.append(f"best: {self._best / _MB:.1f} MB "
                         f"{self._best_compression}{alg}{wire}{topo}")
        return "\n".join(lines)

    # -- GP machinery -----------------------------------------------------
    def _denorm(self, x01: float) -> int:
        return int(round(2 ** (self._lo + x01 * (self._hi - self._lo))))

    def _embed(self, x01: float, comp: int, alg: int = 0, chunk: int = 0,
               wire: int = 0, topo: int = 0):
        import math

        import numpy as np
        coords = [x01]
        if self._tune_comp:
            onehot = [0.0] * len(self.COMPRESSION_CHOICES)
            onehot[comp] = 1.0
            coords += onehot
        if self._tune_alg:
            onehot = [0.0] * len(self.ALGORITHM_CHOICES)
            onehot[alg] = 1.0
            coords += onehot
            # chunk count embeds as a normalized log2 scalar (it is
            # ordinal, unlike the algorithm category)
            span = math.log2(max(self.CHUNK_CHOICES))
            coords.append(math.log2(self.CHUNK_CHOICES[chunk])
                          / max(span, 1.0))
        if self._tune_wire:
            onehot = [0.0] * len(self.WIRE_CHOICES)
            onehot[wire] = 1.0
            coords += onehot
        if self._tune_topology:
            onehot = [0.0] * len(self.TOPOLOGY_CHOICES)
            onehot[topo] = 1.0
            coords += onehot
        return np.array(coords)

    def _next_point(self) -> tuple:
        """Initial quasi-random design for 3 probes, then GP + expected
        improvement over a dense candidate grid."""
        import numpy as np
        n_comp = len(self.COMPRESSION_CHOICES) if self._tune_comp else 1
        n_alg = len(self.ALGORITHM_CHOICES) if self._tune_alg else 1
        n_chunk = len(self.CHUNK_CHOICES) if self._tune_alg else 1
        n_wire = len(self.WIRE_CHOICES) if self._tune_wire else 1
        n_topo = len(self.TOPOLOGY_CHOICES) if self._tune_topology else 1
        n = len(self._xs)
        if n < 3:
            # fixed space-filling start: ends + middle of the log range,
            # cycling the categorical choices so every axis gets data
            return ((0.0, 0.5, 1.0)[n], n % n_comp, n % n_alg,
                    n % n_chunk, n % n_wire, n % n_topo)
        X = np.stack([self._embed(*p) for p in self._xs])
        y = np.asarray(self._ys)
        y_mu, y_sd = y.mean(), max(y.std(), 1e-12)
        yn = (y - y_mu) / y_sd
        ell, sf2, sn2 = 0.25, 1.0, 1e-4

        def kern(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return sf2 * np.exp(-d2 / (2 * ell * ell))

        K = kern(X, X) + sn2 * np.eye(n)
        # candidates: dense threshold grid x every category combination
        # (the grid coarsens as categorical axes multiply so the EI argmax
        # stays a few-thousand-point scan)
        grid = np.linspace(
            0.0, 1.0, 65 if n_wire == 1 and n_topo == 1 else 33)
        cands = [(g, c, a, ch, w, t)
                 for t in range(n_topo) for w in range(n_wire)
                 for ch in range(n_chunk) for a in range(n_alg)
                 for c in range(n_comp) for g in grid]
        Xc = np.stack([self._embed(*p) for p in cands])
        Ks = kern(Xc, X)
        sol = np.linalg.solve(K, np.eye(n))
        mu = Ks @ sol @ yn
        var = np.maximum(sf2 - np.einsum("ij,jk,ik->i", Ks, sol, Ks), 1e-12)
        sd = np.sqrt(var)
        # expected improvement (minimization), erf-based normal cdf/pdf
        from math import erf, pi
        best = yn.min()
        z = (best - mu) / sd
        cdf = 0.5 * (1 + np.vectorize(erf)(z / np.sqrt(2)))
        pdf = np.exp(-0.5 * z * z) / np.sqrt(2 * pi)
        ei = (best - mu) * cdf + sd * pdf
        return cands[int(np.argmax(ei))]
