"""Query planner and block autotuner: the backend, encoding and block
shape a workload runs.

The port of ``repro.core.autotune``.  The step has four interchangeable
backends (:mod:`.backend`) over three encodings, and two of them launch
hand-written kernels whose block shape (:class:`~.plan.KernelConfig`:
rows a block, threads a block) is a choice too.  Which is fastest depends
on the workload, so the entry points ask this module when the caller
leaves the choice open (:func:`~.backend.resolve_entry_info`).  Decision
flow::

    workload signature (m, n, K_in, B, T, semantics)
        │
        ├─ 1. autotune cache ──  on-disk JSON of measured winners, then
        │                        the committed seed rows (timed on the
        │                        card by chip_smoke.py's phase 19)
        ├─ 2. cost model ─────── per-backend log-log curves
        │                        us ≈ A·W^p over the dense work proxy
        │                        W = B·T·n·m, fitted to the seed rows;
        │                        on the card only for a system the rows
        │                        time (its m, n and tier), fitted to its
        │                        rows alone, inside the span of W they
        │                        cover for every kernel that takes it
        └─ 3. nothing to say ─── the caller falls through to the
                                 port's encoding rule (``plan_for``
                                 returns None)

``mode="measure"`` times the candidate grid on the spot instead
(:func:`measure_best`) and stores the winner in the cache.  A block
shape other than the library's rule wins only by more than the timing's
spread (:func:`_pick`), in a sweep and among seed rows alike, so noise
never pins a shape.

What differs from the reference:

* *Own paths.*  The cache is ``$REPRO_TORCH_AUTOTUNE_CACHE``, else
  ``~/.cache/repro-snp-torch/autotune.json``.  Seed rows come from
  ``$REPRO_TORCH_BENCH_BASELINE``, else the committed
  ``autotune_seed.json`` beside this module: rows in the reference's
  format (``"name": "snp_step/<backend>/m{m}_n{n}_B{B}_T{T}"``,
  ``us_per_call``; delayed rows under the tier ``snp_step_delays``)
  plus each row's ``block_t`` and ``threads`` (``null``: the rule) and
  ``spread_us``, and a ``device`` record naming the card and its power
  limit.  The reference's ``BENCH_snp.json`` (CPU timings of Pallas
  kernels in interpret mode) never seeds this planner, and no fit comes
  from anything but the seed rows: without them the model is silent.
* *Fits per system on the card.*  The reference fits the delay-free
  rows of every system to one curve a backend and prices every signature
  by it; so does the port off the card.  On the card W alone does not
  rank the backends (one curve over two seeded graphs of different
  structure ranks them wrongly at seeded points), so the model
  interpolates between the rows of the signature's own system and tier
  and extrapolates nowhere (the module's flow above).
* *No interpret guard.*  No port backend is interpreted, so the
  reference's ``_INTERPRET_KERNELS`` extrapolation guard has no
  counterpart.  In its place the cache, the model and the candidate grid
  drop a kernel choice outside its kernel's domain (:func:`_in_domain`:
  a block shape the kernel has no instance for, a system wider than the
  library takes, a stage that does not fit), so nothing is chosen and
  then refused.
* *Kernels only on the card.*  On a CUDA device the choices keep to
  :data:`~.failover.KERNEL_BACKENDS`; a cached or seeded entry naming a
  plain backend is unusable there.  On the CPU all four backends are
  candidates, as in the reference.
* *No fallback that hides a kernel.*  :func:`measure_best` skips only a
  candidate its kernel refuses as outside its domain (``ValueError``,
  recorded in :data:`last_sweep`); any other failure, a kernel that does
  not build or launch, propagates.

A corrupt or poisoned cache file degrades to the model with a
``UserWarning``; it never crashes a plan.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import time
import warnings
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .backend import (_check_kernel_plan, available_backends,
                      compile_with_plan, get_backend, resolve_kernel,
                      supported_under)
from .device import DeviceLike, resolve_device
from .failover import KERNEL_BACKENDS
from .plan import KernelConfig, SystemPlan, _in_degrees, auto_hub_threshold
from .system import SNPSystem

__all__ = ["DEFAULT_WORKLOAD", "TunedChoice", "WorkloadSignature",
           "cache_path", "choice_to_plan", "default_candidates",
           "last_sweep", "load_cache", "lookup", "measure_best",
           "model_choice", "plan_for", "predict_us", "save_cache",
           "seed_path", "signature_of", "store_choice"]

# Workload assumed when the caller gives no (B, T) hint.
DEFAULT_WORKLOAD: Tuple[int, int] = (64, 32)

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_BASELINE_ENV = "REPRO_TORCH_BENCH_BASELINE"
_CACHE_VERSION = 1
_SEED_FILE = Path(__file__).resolve().with_name("autotune_seed.json")

# The candidate grid's block shapes (block_t, threads) per kernel, the
# library's rule (None, None) first: at the full-width waves that is 16
# rows for B1 and 8 rows x 1024 threads for B4 and the sliced-list kernel.
_GRID = {"B1": ((None, None), (32, None)),
         "B4": ((None, None), (8, 256)),
         "sell": ((None, None), (8, 256), (4, 1024))}

_ROW_SHAPE = re.compile(r"m(\d+)_n(\d+)_B(\d+)_T(\d+)$")
_TIERS = {"snp_step": "no_delays", "snp_step_large": "no_delays",
          "snp_step_delays": "delays"}

#: The last :func:`measure_best` sweep, one dict a candidate: its
#: ``backend``, ``block_t``, ``threads``, the median ``us`` it took and
#: the ``spread_us`` of its samples, or the ``refused`` reason its kernel
#: gave.
last_sweep: List[dict] = []


@dataclasses.dataclass(frozen=True)
class WorkloadSignature:
    """The ``(m, n, K_in, B, T, semantics)`` key a decision is valid for:
    neurons, rules, max in-degree, frontier batch, branch cap, semantics
    tier.  The two tiers never share a cache entry."""

    m: int
    n: int
    kin: int
    B: int
    T: int
    semantics: str = "no_delays"

    @property
    def work(self) -> float:
        """Dense work proxy ``W = B·T·n·m``."""
        return float(self.B) * self.T * self.n * self.m

    def _suffix(self) -> str:
        return "_delays" if self.semantics == "delays" else ""

    def key(self) -> str:
        return (f"m{self.m}_n{self.n}_kin{self.kin}"
                f"_B{self.B}_T{self.T}{self._suffix()}")

    def wildcard_key(self) -> str:
        """The key with the in-degree wildcarded, as seeded entries (which
        know only ``(m, n, B, T)``) are keyed."""
        return f"m{self.m}_n{self.n}_kin*_B{self.B}_T{self.T}{self._suffix()}"


@dataclasses.dataclass(frozen=True)
class TunedChoice:
    """One decision: backend, encoding, block shape, the measured or
    predicted µs a step, and its source (``"seed"``, ``"cache"``,
    ``"model"`` or ``"measure"``)."""

    backend: str
    encoding: str = "auto"
    hub_threshold: Optional[int] = None
    block_t: Optional[int] = None
    threads: Optional[int] = None
    us_per_step: Optional[float] = None
    source: str = "model"

    def kernel(self) -> Optional[KernelConfig]:
        if self.block_t is None and self.threads is None:
            return None
        return KernelConfig(block_t=self.block_t, threads=self.threads)


def signature_of(system: SNPSystem, *,
                 workload: Optional[Tuple[int, int]] = None,
                 semantics: str = "no_delays") -> WorkloadSignature:
    """The signature of running ``system`` at ``workload=(B, T)``
    (:data:`DEFAULT_WORKLOAD` without a hint)."""
    B, T = workload if workload is not None else DEFAULT_WORKLOAD
    in_deg = _in_degrees(system)
    kin = int(in_deg.max()) if in_deg.size else 0
    return WorkloadSignature(m=system.num_neurons, n=system.num_rules,
                             kin=kin, B=int(B), T=int(T),
                             semantics=semantics)


def _on_card(device: DeviceLike) -> bool:
    return device is None or torch.device(device).type == "cuda"


def _names(device: DeviceLike) -> Tuple[str, ...]:
    """The backends a decision may name on ``device``."""
    return KERNEL_BACKENDS if _on_card(device) else available_backends()


def _max_width(backend: str) -> int:
    """The widest system ``backend``'s kernel takes (neurons, with a
    shard's halo slots), from the wrappers' stage limit
    (:data:`~repro_torch.kernels.snp_step.sparse_ops.SMEM_LIMIT`, which
    the smoke holds to the library's)."""
    from ..kernels.snp_step import sparse_ops
    return sparse_ops.SMEM_LIMIT // (2 if backend == "sparse_cuda" else 4) \
        - 1


def _in_domain(choice: TunedChoice, sig: WorkloadSignature, *,
               sharded: bool = False) -> bool:
    """Whether ``choice``'s kernel takes ``sig``'s system at its block
    shape: a shape the kernel has an instance for, a width the library
    takes, a stage that fits (rows above T clipped as the wrappers clip
    them).  A sharded plan is judged at the single-device width.  Plain
    backends take everything."""
    if choice.backend not in KERNEL_BACKENDS:
        return True
    try:
        _check_kernel_plan(get_backend(choice.backend), SystemPlan(
            semantics=sig.semantics, num_shards=2 if sharded else 1,
            kernel=choice.kernel()))
    except ValueError:
        return False
    if choice.backend == "cuda" and (sharded or sig.semantics != "delays"):
        return True                     # B1 and B6 take any width
    most = _max_width(choice.backend)
    if sig.m > most:
        return False
    rows = choice.block_t
    if rows is None:
        return True
    while rows > 1 and rows > sig.T:
        rows >>= 1
    return rows * (sig.m + 1) <= most + 1


# ---------------------------------------------------------------------------
# On-disk cache
# ---------------------------------------------------------------------------


def cache_path() -> Path:
    env = os.environ.get(_CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-snp-torch" / "autotune.json"


def load_cache(path: Optional[Path] = None) -> Dict[str, dict]:
    """The cache's ``{signature key: entry}`` map.  A missing file is an
    empty cache; an unreadable or corrupt one warns and reads as empty."""
    path = cache_path() if path is None else Path(path)
    if not path.exists():
        return {}
    try:
        payload = json.loads(path.read_text())
        entries = payload["entries"]
        if not isinstance(entries, dict):
            raise TypeError("entries is not a mapping")
        return entries
    except Exception as exc:  # corrupt or poisoned file: degrade
        warnings.warn(
            f"autotune cache {path} is unreadable ({exc}); ignoring it — "
            "planning falls back to the cost model",
            UserWarning, stacklevel=2)
        return {}


def save_cache(entries: Dict[str, dict],
               path: Optional[Path] = None) -> None:
    """Write the cache atomically (a temporary file, then a rename)."""
    path = cache_path() if path is None else Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(
        {"version": _CACHE_VERSION, "entries": entries},
        indent=1, sort_keys=True))
    tmp.replace(path)


def _entry_to_choice(entry, source: Optional[str] = None
                     ) -> Optional[TunedChoice]:
    """The :class:`TunedChoice` of one cache entry, or ``None`` for a
    poisoned one (wrong types, an unknown backend, bad block values)."""
    try:
        if not isinstance(entry, dict):
            return None
        name = entry["backend"]
        if name not in available_backends():
            return None
        choice = TunedChoice(
            backend=str(name),
            encoding=str(entry.get("encoding", "auto")),
            hub_threshold=entry.get("hub_threshold"),
            block_t=entry.get("block_t"),
            threads=entry.get("threads"),
            us_per_step=entry.get("us_per_step"),
            source=source or str(entry.get("source", "cache")),
        )
        choice.kernel()  # raises on invalid block values
        if choice.encoding not in ("auto", "dense", "ell", "hybrid"):
            return None
        return choice
    except Exception:
        return None


def _choice_to_entry(choice: TunedChoice) -> dict:
    return {"backend": choice.backend, "encoding": choice.encoding,
            "hub_threshold": choice.hub_threshold,
            "block_t": choice.block_t, "threads": choice.threads,
            "us_per_step": choice.us_per_step, "source": choice.source}


def store_choice(sig: WorkloadSignature, choice: TunedChoice,
                 path: Optional[Path] = None) -> None:
    """Store ``choice`` as the winner for ``sig`` (its exact key)."""
    entries = load_cache(path)
    entries[sig.key()] = _choice_to_entry(choice)
    save_cache(entries, path)


# ---------------------------------------------------------------------------
# Seed rows
# ---------------------------------------------------------------------------


class _Row(NamedTuple):
    backend: str
    m: int
    n: int
    B: int
    T: int
    us: float
    semantics: str
    block_t: Optional[int]
    threads: Optional[int]
    spread: float


def seed_path() -> Optional[Path]:
    """``$REPRO_TORCH_BENCH_BASELINE``, else the committed seed file;
    ``None`` when it does not exist."""
    env = os.environ.get(_BASELINE_ENV)
    p = Path(env) if env else _SEED_FILE
    return p if p.exists() else None


def _baseline_rows() -> List[_Row]:
    """One :class:`_Row` per step row of the seed file (tiers
    ``snp_step``, ``snp_step_large`` and ``snp_step_delays``: rows that
    time one expansion); malformed rows are skipped."""
    path = seed_path()
    if path is None:
        return []
    try:
        rows = json.loads(path.read_text())["rows"]
    except Exception:
        return []
    out = []
    names = available_backends()
    for row in rows:
        try:
            parts = str(row["name"]).split("/")
            semantics = _TIERS.get(parts[0])
            shape = _ROW_SHAPE.search(parts[-1])
            backend = next(p for p in parts[1:] if p in names)
            if semantics is None or shape is None:
                continue
            m, n, B, T = map(int, shape.groups())
            out.append(_Row(backend, m, n, B, T, float(row["us_per_call"]),
                            semantics, row.get("block_t"),
                            row.get("threads"),
                            float(row.get("spread_us") or 0.0)))
        except Exception:
            continue
    return out


def _pick(timed: List[Tuple[TunedChoice, float]]) -> Optional[TunedChoice]:
    """The fastest of ``timed`` (each choice with its µs, beside the spread
    of its samples), with one guard: a block shape displaces its backend's
    rule (the choice with no shape) only when it is faster by more than
    the larger of the two spreads."""
    if not timed:
        return None
    best, spread = min(timed, key=lambda t: t[0].us_per_step)
    rule = next(((c, s) for c, s in timed
                 if c.backend == best.backend and c.kernel() is None), None)
    if rule is not None and rule[0].us_per_step - best.us_per_step <= \
            max(spread, rule[1]):
        return rule[0]
    return best


def _seed_entries() -> Dict[str, dict]:
    """Wildcard-kin cache entries from the seed rows: per ``(m, n, B, T,
    semantics)``, the :func:`_pick` of its rows."""
    groups: Dict[tuple, List[Tuple[TunedChoice, float]]] = {}
    for row in _baseline_rows():
        groups.setdefault((row.m, row.n, row.B, row.T, row.semantics),
                          []).append((TunedChoice(
                              backend=row.backend, block_t=row.block_t,
                              threads=row.threads, us_per_step=row.us,
                              source="seed"), row.spread))
    entries = {}
    for (m, n, B, T, semantics), timed in groups.items():
        sig = WorkloadSignature(m=m, n=n, kin=0, B=B, T=T,
                                semantics=semantics)
        entries[sig.wildcard_key()] = _choice_to_entry(_pick(timed))
    return entries


def lookup(sig: WorkloadSignature, *, sharded: bool = False,
           device: DeviceLike = None) -> Optional[TunedChoice]:
    """The cache's decision: the exact key, then the wildcard-kin key;
    stored entries (``source="cache"``) before seeds (``"seed"``).
    ``None`` on a miss, or when every hit is poisoned or unusable on
    ``device`` (``None`` = the card)."""
    disk = load_cache()
    seeds = _seed_entries()
    for key in (sig.key(), sig.wildcard_key()):
        for table, source in ((disk, "cache"), (seeds, "seed")):
            if key in table:
                choice = _entry_to_choice(table[key], source=source)
                if choice is not None and _usable(
                        choice, sharded=sharded, semantics=sig.semantics,
                        device=device) and _in_domain(
                            choice, sig, sharded=sharded):
                    return choice
    return None


def _usable(choice: TunedChoice, *, sharded: bool,
            semantics: str = "no_delays", device: DeviceLike = None) -> bool:
    if choice.backend not in _names(device):
        return False
    sup = supported_under(get_backend(choice.backend), semantics)
    if sharded:
        return "sharded" in sup
    if not sup:
        return False
    return choice.encoding == "auto" or choice.encoding in sup


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------


def _tier_points(semantics: str, system: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, List[Tuple[float, float]]]:
    """Per backend, the ``(W, µs)`` of the seed rows of one tier (and,
    given ``system=(m, n)``, of that system alone)."""
    pts: Dict[str, List[Tuple[float, float]]] = {}
    for row in _baseline_rows():
        if row.semantics == semantics and row.us > 0 and (
                system is None or (row.m, row.n) == system):
            pts.setdefault(row.backend, []).append(
                (float(row.B) * row.T * row.n * row.m, row.us))
    return pts


def _fitted_curves(semantics: str = "no_delays",
                   system: Optional[Tuple[int, int]] = None
                   ) -> Dict[str, Tuple[float, float, float]]:
    """Per-backend ``(p, logA, Wmax)`` least-squares fits of log µs a
    step against log ``W`` over the seed rows of one tier (of one
    ``system=(m, n)``, given one) (``us ≈ exp(logA)·W^p``); empty without
    seed rows."""
    fits = {}
    for backend, ps in _tier_points(semantics, system).items():
        lw = np.log([w for w, _ in ps])
        lu = np.log([u for _, u in ps])
        if len(set(lw)) >= 2:
            p, logA = np.polyfit(lw, lu, 1)
        else:  # one W: assume a square-root scaling through their mean
            p = 0.5
            logA = float(np.mean(lu) - p * lw[0])
        fits[backend] = (float(p), float(logA), max(w for w, _ in ps))
    return fits


def predict_us(sig: WorkloadSignature, backend: str) -> Optional[float]:
    """The model's µs a step for ``backend`` at ``sig`` (by the curve of
    ``sig``'s tier where the seed rows give one, else the delay-free
    curve, as the reference prices every tier), or ``None`` without a
    curve for it."""
    fit = _fitted_curves(sig.semantics).get(backend) or \
        _fitted_curves().get(backend)
    if fit is None:
        return None
    p, logA, _ = fit
    return math.exp(logA + p * math.log(max(sig.work, 1.0)))


def model_choice(sig: WorkloadSignature, *, sharded: bool = False,
                 device: DeviceLike = None) -> Optional[TunedChoice]:
    """The cheapest backend under the cost model, among those usable on
    ``device`` whose kernel takes the system (at the library's rule
    shape).  On the card the curves are fitted to the seed rows of
    ``sig``'s own system (its ``m`` and ``n``) and tier, and the model
    answers only when each such kernel backend's rows span ``sig``'s
    ``W``: a signature the seeds do not cover gets ``None`` (the caller's
    rule), never an extrapolation."""
    card = _on_card(device)
    tier = sig.semantics if card else "no_delays"
    own = (sig.m, sig.n) if card else None
    pts = _tier_points(tier, own)
    fits = _fitted_curves(tier, own)
    best: Optional[TunedChoice] = None
    for backend in sorted(_names(device)):
        sup = supported_under(get_backend(backend), sig.semantics)
        if not sup or (sharded and "sharded" not in sup):
            continue
        if not _in_domain(TunedChoice(backend=backend), sig,
                          sharded=sharded):
            continue
        if backend not in fits or card and not (
                min(w for w, _ in pts[backend]) <= sig.work
                <= fits[backend][2]):
            if card:
                return None
            continue
        p, logA, _ = fits[backend]
        us = math.exp(logA + p * math.log(max(sig.work, 1.0)))
        if best is None or us < best.us_per_step:
            best = TunedChoice(backend=backend, us_per_step=us,
                               source="model")
    return best


# ---------------------------------------------------------------------------
# Inline measurement (mode="measure")
# ---------------------------------------------------------------------------


def default_candidates(sig: WorkloadSignature, *, sharded: bool = False,
                       device: DeviceLike = None) -> List[TunedChoice]:
    """The grid :func:`measure_best` sweeps: every backend usable on
    ``device`` at its native encoding, the kernel backends at the
    library's rule (no block shape) and one or two other shapes (B1: 32
    rows; B4: 8 rows at 256 threads; the sliced-list kernel: that and 4
    rows at 1024), each kept only where its kernel takes the system.  A
    sharded plan's ``"cuda"`` candidate keeps B6's rule (the sweep times
    B1)."""
    out: List[TunedChoice] = []
    for name in sorted(_names(device)):
        sup = supported_under(get_backend(name), sig.semantics)
        if not sup or (sharded and "sharded" not in sup):
            continue
        if name == "sparse_cuda":
            shapes = _GRID["sell"]
        elif name == "cuda" and not sharded:
            shapes = _GRID["B4" if sig.semantics == "delays" else "B1"]
        else:
            shapes = ((None, None),)
        for bt, nt in shapes:
            cand = TunedChoice(backend=name, block_t=bt, threads=nt)
            if _in_domain(cand, sig, sharded=sharded):
                out.append(cand)
    return out


def _time_step(be, comp, configs, T: int) -> float:
    """µs of one ``be.expand``, the wrapper's host work included, the card
    synchronised before and after."""
    card = configs.device.type == "cuda"
    if card:
        torch.cuda.synchronize(configs.device)
    t0 = time.perf_counter()
    be.expand(configs, comp, T)
    if card:
        torch.cuda.synchronize(configs.device)
    return (time.perf_counter() - t0) * 1e6


def measure_best(system: SNPSystem, sig: WorkloadSignature, *,
                 num_shards: int = 1, reps: int = 5,
                 candidates: Optional[List[TunedChoice]] = None,
                 persist: bool = True,
                 device: DeviceLike = None) -> Optional[TunedChoice]:
    """Time the candidates on ``system`` at ``sig``'s ``(B, T)`` on
    ``device`` (``None`` = the card) and return the :func:`_pick` of their
    medians, stored in the cache so that ``mode="auto"`` finds it.  Each
    candidate makes one untimed call (which builds its kernel's library at
    first use); then ``reps`` rounds time every candidate once in turn,
    so that a drift of the clock falls on all alike.  A candidate its
    kernel refuses as outside its domain (``ValueError``) is skipped and
    its reason kept in :data:`last_sweep`; any other failure propagates.
    ``None`` only when every candidate was refused."""
    dev = resolve_device(device)
    sharded = num_shards > 1
    cands = candidates if candidates is not None else \
        default_candidates(sig, sharded=sharded, device=dev)
    rng = np.random.default_rng(0)
    m = system.num_neurons
    spikes = rng.integers(0, 5, size=(sig.B, m))
    if sig.semantics == "delays":
        # delayed state rows are 3m wide: [spikes | countdown | pending]
        spikes = np.concatenate(
            [spikes, np.zeros((sig.B, 2 * m), spikes.dtype)], axis=1)
    configs = torch.as_tensor(spikes, dtype=torch.int32, device=dev)
    built: Dict[tuple, object] = {}
    live = []
    last_sweep.clear()
    for cand in cands:
        row = dict(backend=cand.backend, block_t=cand.block_t,
                   threads=cand.threads, us=None, spread_us=None,
                   refused=None)
        last_sweep.append(row)
        try:
            # Timed at the single-device lowering even for a sharded
            # plan: a sweep must not take the shards' devices.
            plan = choice_to_plan(cand, system, mode="static",
                                  semantics=sig.semantics)
            if plan is None:
                raise ValueError(f"{cand.backend!r} cannot realise "
                                 f"{cand.encoding!r} here")
            be = resolve_kernel(get_backend(cand.backend), plan)
            key = (cand.backend, plan.encoding, plan.hub_threshold)
            if key not in built:
                built[key] = compile_with_plan(be, system, plan, dev)
            _time_step(be, built[key], configs, sig.T)
        except ValueError as e:
            row["refused"] = str(e)
            continue
        live.append((cand, row, be, built[key], []))
    for _ in range(reps):
        for _, _, be, comp, samples in live:
            samples.append(_time_step(be, comp, configs, sig.T))
    timed = []
    for cand, row, _, _, samples in live:
        samples.sort()
        n = len(samples)
        row["us"] = samples[n // 2]
        row["spread_us"] = samples[(3 * n) // 4] - samples[n // 4]
        timed.append((dataclasses.replace(cand, us_per_step=row["us"],
                                          source="measure"),
                      row["spread_us"]))
    best = _pick(timed)
    if best is not None and persist:
        try:
            store_choice(sig, best)
        except OSError:
            pass  # a read-only cache: the measurement still stands
    return best


# ---------------------------------------------------------------------------
# Planner entry point
# ---------------------------------------------------------------------------


def choice_to_plan(choice: TunedChoice, system: SNPSystem, *,
                   num_shards: int = 1, mode: str = "auto",
                   semantics: str = "no_delays") -> Optional[SystemPlan]:
    """A :class:`SystemPlan` realising ``choice`` on ``system``, or
    ``None`` when it cannot be realised (an encoding its backend lacks
    under the tier).  An ``"auto"`` encoding resolves the sparse pair
    through the degree heuristic (ELL or hybrid), every other backend to
    its native layout; a sharded plan is ELL, with the degree partition
    for a heavy-tailed graph."""
    sup = supported_under(get_backend(choice.backend), semantics)
    if not sup:
        return None
    if num_shards > 1:
        if "sharded" not in sup:
            return None
        in_deg = _in_degrees(system)
        h = auto_hub_threshold(in_deg)
        kin = int(in_deg.max()) if in_deg.size else 0
        part = "degree" if kin > 2 * h else "contiguous"
        return SystemPlan(encoding="ell", num_shards=num_shards,
                          mode=mode, backend=choice.backend,
                          kernel=choice.kernel(), semantics=semantics,
                          partition=part)
    encoding, hub = choice.encoding, choice.hub_threshold
    if encoding == "auto" and sup[0] == "ell":
        in_deg = _in_degrees(system)
        h = auto_hub_threshold(in_deg)
        kin = int(in_deg.max()) if in_deg.size else 0
        if kin > 2 * h and "hybrid" in sup:
            encoding, hub = "hybrid", h
    if encoding != "auto" and encoding not in sup:
        return None
    return SystemPlan(encoding=encoding, hub_threshold=hub, mode=mode,
                      backend=choice.backend, kernel=choice.kernel(),
                      semantics=semantics)


def plan_for(system: SNPSystem, *, num_shards: int = 1,
             workload: Optional[Tuple[int, int]] = None,
             measure: bool = False, semantics: str = "no_delays",
             device: DeviceLike = None) -> Optional[SystemPlan]:
    """The decision flow (module docstring) for running ``system`` on
    ``device`` (``None`` = the card): measure when asked, else the cache,
    then the model.  ``None`` sends the caller back to its rule."""
    sig = signature_of(system, workload=workload, semantics=semantics)
    sharded = num_shards > 1
    if measure:
        choice = measure_best(system, sig, num_shards=num_shards,
                              device=device)
        mode = "measure"
    else:
        choice = lookup(sig, sharded=sharded, device=device) \
            or model_choice(sig, sharded=sharded, device=device)
        mode = "auto"
    if choice is None:
        return None
    return choice_to_plan(choice, system, num_shards=num_shards, mode=mode,
                          semantics=semantics)
