"""Self-tuning backend planner: cutouts, mode-space sweeps, tuning tables.

The port's copy of the reference's ``repro.bench.tuner``, over the port's
registry: its table, built on the synthetic clock, equals the reference's
with the backend names mapped (``bench.names``).

The paper's core finding is that no single runtime wins everywhere —
which backend is fastest flips with task granularity, dependence
pattern, payload size, and device count (§V).  This module closes that
loop DaCe-cutout-tuner style:

cutout
    ``graphs_cutout``/``spec_cutout`` reduce a concrete workload to its
    *tuning key* ``(pattern, granularity bucket, payload bucket, ndev,
    ngraphs)`` — the coordinates the paper's winner actually flips on.

sweep
    ``build_tuning_table`` enumerates the legal backend/mode space
    (``enumerate_mode_space``: every registered backend x the known
    schedule/comm/overlap options from its constructor signature,
    illegal combos pruned by the constructors themselves) and times
    each candidate on a representative corpus cell with the existing
    ``Timer`` protocol.  ``SyntheticTimer`` by default, so tuning is
    deterministic and ~free; wall-clock is opt-in
    (``python -m repro_torch.bench.run --tune --timer wallclock``).

tuning table
    A schema-checked, committed artifact shipped with the package
    (``repro_torch/bench/tuning/TUNE_torch.json``), versioned and
    validated like ``BENCH_*.json``: one entry per tuning key recording
    the winning canonical backend spec, its elapsed time, the measured
    margin over the best strictly-slower alternative, and the full
    candidate timing list.  Regenerate with::

        python -m repro_torch.bench.run --tune --timer synthetic \
            --artifacts src/repro_torch/bench/tuning

dispatch
    ``get_backend("torch-auto")`` (``backends.auto``) consults the
    table at dispatch time via ``TuningTable.resolve`` — exact key
    first, then nearest bucket within the same (pattern, ndev,
    ngraphs), then nearest same-pattern key, then the documented
    fallback (``DEFAULT_FALLBACK``).  Zero per-dispatch measurement:
    resolution is a pure table lookup.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.graph import TaskGraph, make_graph, replicate
from .artifact import SCHEMA_VERSION, _typed

# ---------------------------------------------------------------- buckets

# Mean iterations per task.  fine < 16 <= medium < 256 <= coarse: the
# synthetic model's 50% METG crossover sits at iterations ~400 (where
# iters * 50ns == 20us), so "fine" is deep in dispatch-bound territory,
# "coarse" approaches compute-bound, and "medium" straddles the study
# granularity (STUDY_ITERATIONS = 64).
GRANULARITY_BUCKETS: Tuple[str, ...] = ("fine", "medium", "coarse")
GRANULARITY_EDGES: Tuple[float, ...] = (16.0, 256.0)
GRANULARITY_REPRESENTATIVE: Dict[str, int] = {
    "fine": 1, "medium": 64, "coarse": 1024}

# Payload bytes per dependency.  small < 1 KiB <= medium < 32 KiB <=
# large, bracketing studies.PAYLOAD_BYTES = (16, 4096, 65536).
PAYLOAD_BUCKETS: Tuple[str, ...] = ("small", "medium", "large")
PAYLOAD_EDGES: Tuple[int, ...] = (1024, 32768)
PAYLOAD_REPRESENTATIVE: Dict[str, int] = {
    "small": 16, "medium": 4096, "large": 65536}

# the planner's registry name (the reference's ``auto``; the port's names
# never collide with the reference's artifacts)
AUTO = "torch-auto"

# what ``torch-auto`` dispatches when the table has no usable key (or no
# table is present at all): the single-device backend that runs every
# pattern with no mode prerequisites
DEFAULT_FALLBACK = "torch-scan"

# the committed table's name, ``TUNE_torch.json``: the reference's is
# ``TUNE_default.json``, which its own gate reads
TABLE_SLUG = "torch"


def granularity_bucket(mean_iterations: float) -> str:
    """The granularity bucket of a mean per-task iteration count."""
    if not math.isfinite(mean_iterations) or mean_iterations < 0:
        raise ValueError(
            f"mean_iterations must be finite and >= 0, got {mean_iterations!r}")
    for bucket, edge in zip(GRANULARITY_BUCKETS, GRANULARITY_EDGES):
        if mean_iterations < edge:
            return bucket
    return GRANULARITY_BUCKETS[-1]


def payload_bucket(output_bytes: int) -> str:
    """The payload bucket of a per-dependency output size."""
    if output_bytes < 0:
        raise ValueError(f"output_bytes must be >= 0, got {output_bytes!r}")
    for bucket, edge in zip(PAYLOAD_BUCKETS, PAYLOAD_EDGES):
        if output_bytes < edge:
            return bucket
    return PAYLOAD_BUCKETS[-1]


# ------------------------------------------------------------ tuning key

_KEY_FIELDS: Dict[str, type] = {
    "pattern": str,
    "granularity": str,
    "payload": str,
    "ndev": int,
    "ngraphs": int,
}


@dataclass(frozen=True)
class TuningKey:
    """One cell of the tuning space — what the winner flips on."""

    pattern: str
    granularity: str
    payload: str
    ndev: int = 1
    ngraphs: int = 1

    def __post_init__(self):
        if self.granularity not in GRANULARITY_BUCKETS:
            raise ValueError(
                f"unknown granularity bucket {self.granularity!r}; "
                f"known: {GRANULARITY_BUCKETS}")
        if self.payload not in PAYLOAD_BUCKETS:
            raise ValueError(
                f"unknown payload bucket {self.payload!r}; "
                f"known: {PAYLOAD_BUCKETS}")
        if not self.pattern:
            raise ValueError("tuning key needs a pattern")
        if self.ndev < 1 or self.ngraphs < 1:
            raise ValueError("ndev and ngraphs must be >= 1")

    def to_dict(self) -> Dict[str, object]:
        return {"pattern": self.pattern, "granularity": self.granularity,
                "payload": self.payload, "ndev": self.ndev,
                "ngraphs": self.ngraphs}


def key_order(key: TuningKey) -> Tuple:
    """Deterministic sort order for table entries and diff output."""
    return (key.pattern, GRANULARITY_BUCKETS.index(key.granularity),
            PAYLOAD_BUCKETS.index(key.payload), key.ndev, key.ngraphs)


def key_slug(key: TuningKey) -> str:
    """Compact printable form: ``stencil.fine.small.d1.g1``."""
    return (f"{key.pattern}.{key.granularity}.{key.payload}"
            f".d{key.ndev}.g{key.ngraphs}")


def graphs_cutout(graphs: Sequence[TaskGraph], ndev: int = 1) -> TuningKey:
    """Reduce a concrete workload (the graphs a backend is about to run)
    to its tuning key.

    Pattern and payload come from the first graph (a heterogeneous batch
    tunes on its leading graph — the nearest single key the table can
    hold); granularity is the batch-wide mean iterations per task, so an
    imbalanced graph lands in the bucket of its *average* task.
    """
    graphs = list(graphs)
    if not graphs:
        raise ValueError("cutout needs at least one graph")
    total_tasks = sum(g.num_tasks for g in graphs)
    total_iters = sum(g.total_iterations() for g in graphs)
    mean_iters = total_iters / max(total_tasks, 1)
    return TuningKey(
        pattern=graphs[0].pattern,
        granularity=granularity_bucket(mean_iters),
        payload=payload_bucket(graphs[0].output_bytes),
        ndev=max(int(ndev), 1),
        ngraphs=len(graphs))


def spec_cutout(spec, ndev: int = 1) -> TuningKey:
    """The tuning key of a single-point ``ScenarioSpec``.

    A multi-point sweep spans several granularity buckets — each point
    resolves separately at dispatch time — so the spec-level cutout only
    exists for fixed-granularity specs (the study families).
    """
    schedule = spec.sweep.iteration_schedule()
    if len(schedule) != 1:
        raise ValueError(
            f"spec_cutout needs a single-point sweep (one granularity is "
            f"one tuning key); {spec.name!r} sweeps {schedule} — cut out "
            f"one point, or use graphs_cutout on that point's graphs")
    return graphs_cutout(spec.resolved().graphs(schedule[0]), ndev=ndev)


# ------------------------------------------------- mode-space enumeration

# the mode axes the paper studies (backend x schedule x comm x overlap);
# each backend only sweeps the axes its constructor actually accepts
# (backend_option_signature), and values equal to the constructor default
# collapse into the bare name so the canonical rendering is unique
_MODE_SPACE: Dict[str, Tuple[object, ...]] = {
    "schedule": ("static", "steal"),
    "comm": ("auto", "onesided"),
    "comm_overlap": (False, True),
}


def backend_mode_specs(name: str) -> List[str]:
    """The legal canonical mode specs of one registered backend.

    Intersects ``_MODE_SPACE`` with the backend's known-options metadata
    (its constructor signature), then prunes combos the constructor
    rejects — e.g. ``cuda-fused[comm=auto]`` (the fused kernel only
    accepts one-sided or no comm mode) never becomes a candidate.  The
    veto builds each combination on the CPU (``device="cpu"``, never part
    of the spec), so it needs no card and starts no rank process.
    """
    from ..backends.base import (backend_option_signature,
                                 canonical_backend_spec, get_backend)

    sig = backend_option_signature(name)
    on_cpu = {"device": "cpu"} if "device" in sig else {}
    axes = [k for k in _MODE_SPACE if sig is not None and k in sig]
    specs = {name}
    for combo in itertools.product(*(_MODE_SPACE[k] for k in axes)):
        kwargs = {k: v for k, v in zip(axes, combo) if v != sig[k]}
        if not kwargs:
            continue  # all-defaults combo == the bare name
        opts = ",".join(f"{k}={v}" for k, v in sorted(kwargs.items()))
        spec = canonical_backend_spec(f"{name}[{opts}]")
        try:
            get_backend(spec, **on_cpu)
        except (ValueError, KeyError):
            continue  # the constructor vetoed the combo: not legal
        specs.add(spec)
    return sorted(specs)


def enumerate_mode_space() -> List[str]:
    """Every legal candidate spec: all registered backends x their modes.

    ``torch-auto`` itself is excluded — the planner never times itself.
    """
    from ..backends.base import backend_names

    out: List[str] = []
    for name in backend_names():
        if name == AUTO:
            continue
        out.extend(backend_mode_specs(name))
    return sorted(out)


# ------------------------------------------------------- tuning corpus

# full-grid patterns: the three dependence shapes the committed bench
# corpus sweeps (stencil/nearest/spread cover halo, ring and allgather
# comm planning); the reduced smoke grid keeps stencil only
TUNE_PATTERNS: Tuple[str, ...] = ("stencil", "nearest", "spread")
SMOKE_PATTERNS: Tuple[str, ...] = ("stencil",)
_TUNE_WIDTH = 8
_TUNE_HEIGHT = 16
_SMOKE_HEIGHT = 8


@dataclass(frozen=True)
class TuningCell:
    """One corpus cell: a tuning key, its family, the candidate specs to
    race, and the representative graphs they race on."""

    key: TuningKey
    family: str
    candidates: Tuple[str, ...]
    graphs: Tuple[TaskGraph, ...]


def _comm_candidates() -> Tuple[str, ...]:
    """The communication-mode spectrum the payload cells race: blocking
    (bare), double-buffered overlap, and one-sided put/signal, on both
    SPMD backends.  The fused megakernel is excluded here on purpose:
    its synthetic per-launch model carries no per-message comm term, so
    racing it in a communication study would be a model artifact, not a
    comm-mode comparison."""
    out: List[str] = []
    for b in ("torch-csp", "torch-pipeline"):
        out.extend((b, f"{b}[comm_overlap=True]", f"{b}[comm=onesided]"))
    return tuple(sorted(out))


def tuning_corpus(smoke: bool = False) -> List[TuningCell]:
    """The representative cells the sweep races candidates on.

    One cell per (pattern x granularity bucket) at small payload plus a
    task-parallelism cell (the ``metg`` family's axes), and one cell per
    larger payload bucket at the study granularity (the ``metg_payload``
    family's axis).  ``smoke=True`` is the reduced grid: a strict
    subset of the full grid's keys (same buckets, shallower graphs), so
    the smoke table diffs cleanly against the committed full table.
    """
    mode_space = tuple(enumerate_mode_space())
    height = _SMOKE_HEIGHT if smoke else _TUNE_HEIGHT
    cells: List[TuningCell] = []
    grans = ("fine", "medium") if smoke else GRANULARITY_BUCKETS
    for pattern in (SMOKE_PATTERNS if smoke else TUNE_PATTERNS):
        for gran in grans:
            g = make_graph(width=_TUNE_WIDTH, height=height, pattern=pattern,
                           kernel="compute",
                           iterations=GRANULARITY_REPRESENTATIVE[gran],
                           output_bytes=PAYLOAD_REPRESENTATIVE["small"])
            cells.append(TuningCell(
                key=TuningKey(pattern, gran, "small"),
                family="metg", candidates=mode_space, graphs=(g,)))
    if not smoke:
        # task parallelism (paper Fig 9d): 4 concurrent fine graphs
        g = make_graph(width=_TUNE_WIDTH, height=height, pattern="nearest",
                       kernel="compute", iterations=1,
                       output_bytes=PAYLOAD_REPRESENTATIVE["small"])
        cells.append(TuningCell(
            key=TuningKey("nearest", "fine", "small", ngraphs=4),
            family="metg", candidates=mode_space,
            graphs=tuple(replicate(g, 4))))
    comm = _comm_candidates()
    for pb in (("large",) if smoke else ("medium", "large")):
        g = make_graph(width=_TUNE_WIDTH, height=height, pattern="stencil",
                       kernel="compute",
                       iterations=GRANULARITY_REPRESENTATIVE["medium"],
                       output_bytes=PAYLOAD_REPRESENTATIVE[pb])
        cells.append(TuningCell(
            key=TuningKey("stencil", "medium", pb),
            family="metg_payload", candidates=comm, graphs=(g,)))
    seen = set()
    for cell in cells:
        if cell.key in seen:
            raise ValueError(f"tuning corpus has duplicate key "
                             f"{key_slug(cell.key)}")
        seen.add(cell.key)
    return cells


def _cell_timer(base_timer, family: str):
    """The timer a family's cells race on.  ``metg_payload`` specializes
    the synthetic clock with the study's byte/rendezvous rates (the same
    knobs ``bench_metg_payload`` measures with) so the comm modes are
    distinguishable; non-synthetic timers pass through unchanged."""
    if family == "metg_payload":
        from .studies import (SECONDS_PER_BYTE, SECONDS_PER_RENDEZVOUS,
                              study_timer)

        return study_timer(base_timer, seconds_per_byte=SECONDS_PER_BYTE,
                           seconds_per_rendezvous=SECONDS_PER_RENDEZVOUS)
    return base_timer


# -------------------------------------------------------------- sweep

def build_tuning_table(timer=None, smoke: bool = False) -> Dict:
    """Race every candidate on every corpus cell; returns the validated
    tuning-table document.

    Ties break deterministically on the canonical spec string, so the
    bare/base spelling of a mode family wins over its no-op variants.
    ``margin`` is the relative cost of the best *strictly slower*
    alternative — "what you lose by picking the next-best distinct
    choice" — and 0.0 when every candidate ties.
    """
    from .timers import SyntheticTimer, timer_config

    if timer is None:
        timer = SyntheticTimer()
    entries: List[Dict] = []
    for cell in tuning_corpus(smoke=smoke):
        cell_timer = _cell_timer(timer, cell.family)
        timed = sorted(
            (float(cell_timer.measure(spec, list(cell.graphs))), spec)
            for spec in cell.candidates)
        best, winner = timed[0]
        if not (math.isfinite(best) and best > 0):
            # a candidate timing 0 (or NaN) cannot be ranked — surface
            # the cell, don't let the margin division or the schema
            # check produce a less-specific error downstream
            raise ValueError(
                f"candidate {winner!r} timed {best!r}s at tuning cell "
                f"{key_slug(cell.key)}; tuning needs finite positive "
                f"times (wall-clock runs may need larger graphs)")
        slower = [t for t, _ in timed if t > best]
        margin = (min(slower) - best) / best if slower else 0.0
        entries.append({
            "key": cell.key.to_dict(),
            "family": cell.family,
            "winner": winner,
            "elapsed_s": best,
            "margin": margin,
            "candidates": [[spec, t] for t, spec in timed],
        })
    entries.sort(key=lambda e: key_order(TuningKey(**e["key"])))
    return validate_tuning_table({
        "schema": SCHEMA_VERSION,
        "kind": "tuning_table",
        "timer": timer.name,
        "timer_config": timer_config(timer),
        "entries": entries,
    })


# ------------------------------------------------- table schema + files

def validate_tuning_table(doc: Dict) -> Dict:
    """Schema check (raises ValueError); returns ``doc`` for chaining.

    Mirrors ``artifact.validate_artifact``: bools are not numbers,
    NaN/inf are corruption, unknown key fields are named, duplicate keys
    are rejected, and the winner must be a canonical spec drawn from the
    recorded candidate list.
    """
    from ..backends.base import canonical_backend_spec

    def need(cond, msg):
        if not cond:
            raise ValueError(f"invalid tuning table: {msg}")

    need(isinstance(doc, dict), "not an object")
    need(doc.get("schema") == SCHEMA_VERSION,
         f"schema must be {SCHEMA_VERSION}, got {doc.get('schema')!r}")
    need(doc.get("kind") == "tuning_table",
         f"kind must be 'tuning_table', got {doc.get('kind')!r}")
    need(isinstance(doc.get("timer"), str) and doc.get("timer"),
         f"timer must be a non-empty string, got {doc.get('timer')!r}")
    need(isinstance(doc.get("timer_config"), dict), "timer_config")
    entries = doc.get("entries")
    need(isinstance(entries, list) and entries,
         "entries must be a non-empty list")
    seen = set()
    for n, e in enumerate(entries):
        need(isinstance(e, dict), f"entries[{n}] not an object")
        key = e.get("key")
        need(isinstance(key, dict), f"entries[{n}].key missing")
        for k in key:
            need(k in _KEY_FIELDS,
                 f"entries[{n}].key has unknown field {k!r}; "
                 f"known: {sorted(_KEY_FIELDS)}")
        for k, t in _KEY_FIELDS.items():
            if t is str:
                need(isinstance(key.get(k), str) and key.get(k),
                     f"entries[{n}].key.{k} must be a non-empty string")
            else:
                need(_typed(key.get(k), int) and key[k] >= 1,
                     f"entries[{n}].key.{k} must be an int >= 1")
        need(key["granularity"] in GRANULARITY_BUCKETS,
             f"entries[{n}].key.granularity {key['granularity']!r} is not "
             f"a bucket; known: {GRANULARITY_BUCKETS}")
        need(key["payload"] in PAYLOAD_BUCKETS,
             f"entries[{n}].key.payload {key['payload']!r} is not a "
             f"bucket; known: {PAYLOAD_BUCKETS}")
        tk = TuningKey(**key)
        need(tk not in seen, f"duplicate tuning key {key_slug(tk)}")
        seen.add(tk)
        need(isinstance(e.get("family"), str) and e["family"],
             f"entries[{n}].family must be a non-empty string")
        need(_typed(e.get("margin"), (int, float)) and e["margin"] >= 0,
             f"entries[{n}].margin must be a finite number >= 0, "
             f"got {e.get('margin')!r}")
        need(_typed(e.get("elapsed_s"), (int, float)) and e["elapsed_s"] > 0,
             f"entries[{n}].elapsed_s must be a finite number > 0")
        cands = e.get("candidates")
        need(isinstance(cands, list) and cands,
             f"entries[{n}].candidates must be a non-empty list")
        specs = []
        for m, c in enumerate(cands):
            need(isinstance(c, (list, tuple)) and len(c) == 2,
                 f"entries[{n}].candidates[{m}] must be a [spec, seconds] "
                 f"pair")
            spec, t = c
            need(isinstance(spec, str) and spec,
                 f"entries[{n}].candidates[{m}] spec must be a non-empty "
                 f"string")
            need(_typed(t, (int, float)) and t > 0,
                 f"entries[{n}].candidates[{m}] seconds must be a finite "
                 f"number > 0")
            specs.append(spec)
        w = e.get("winner")
        need(isinstance(w, str) and w,
             f"entries[{n}].winner must be a non-empty string")
        try:
            canonical = canonical_backend_spec(w)
        except ValueError:
            need(False, f"entries[{n}].winner {w!r} is not a parseable "
                        f"backend spec")
        need(canonical == w, f"entries[{n}].winner {w!r} is not canonical "
                             f"(expected {canonical!r})")
        need(w in specs,
             f"entries[{n}].winner {w!r} is not among its candidates")
    return doc


def tuning_table_path(outdir: str, slug: str = TABLE_SLUG) -> str:
    """Where ``write_tuning_json`` puts a table: ``TUNE_<slug>.json``."""
    return os.path.join(outdir, f"TUNE_{slug}.json")


def write_tuning_json(doc: Dict, outdir: str, slug: str = TABLE_SLUG) -> str:
    """Write a validated tuning table atomically; returns the path."""
    validate_tuning_table(doc)
    os.makedirs(outdir, exist_ok=True)
    path = tuning_table_path(outdir, slug)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def read_tuning_json(path: str) -> Dict:
    """Read + schema-check one tuning table.

    Truncated or garbage files raise ``ValueError`` naming the path (not
    a bare ``JSONDecodeError``) — same contract as ``read_bench_json``.
    """
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"invalid tuning table: {path} is not valid JSON "
                f"(truncated or garbage: {e})") from e
    return validate_tuning_table(doc)


def tuning_json_names(dirpath: str) -> List[str]:
    """Sorted TUNE_*.json filenames under ``dirpath``."""
    return sorted(f for f in os.listdir(dirpath)
                  if f.startswith("TUNE_") and f.endswith(".json"))


# ------------------------------------------------------- resolution

class TuningTable:
    """A validated tuning table with nearest-key resolution."""

    def __init__(self, doc: Dict, path: Optional[str] = None):
        self.doc = validate_tuning_table(doc)
        self.path = path
        self._entries: Dict[TuningKey, Dict] = {
            TuningKey(**e["key"]): e for e in doc["entries"]}

    @property
    def timer(self) -> str:
        return self.doc["timer"]

    def keys(self) -> List[TuningKey]:
        return sorted(self._entries, key=key_order)

    def entry(self, key: TuningKey) -> Optional[Dict]:
        """Exact-key lookup only (no nearest-neighbor semantics)."""
        return self._entries.get(key)

    def resolve_entry(self, key: TuningKey) -> Optional[Dict]:
        """Nearest tuning entry, in three tiers.

        1. the exact key;
        2. same (pattern, ndev, ngraphs): the entry at minimum bucket
           distance (|Δgranularity index| + |Δpayload index|);
        3. same pattern only: minimum bucket distance, then nearest
           ngraphs, then nearest ndev.

        A different *pattern* is never substituted — the dependence
        shape changes which comm plan even exists — so a pattern the
        table has not seen resolves to ``None`` (callers fall back).
        All tie-breaks are deterministic (bucket indices, then the
        winner spec), so resolution is stable across runs.
        """
        if key in self._entries:
            return self._entries[key]
        gi = GRANULARITY_BUCKETS.index(key.granularity)
        pi = PAYLOAD_BUCKETS.index(key.payload)

        def bucket_dist(k: TuningKey) -> int:
            return (abs(GRANULARITY_BUCKETS.index(k.granularity) - gi)
                    + abs(PAYLOAD_BUCKETS.index(k.payload) - pi))

        def tie(k: TuningKey) -> Tuple:
            return (GRANULARITY_BUCKETS.index(k.granularity),
                    PAYLOAD_BUCKETS.index(k.payload),
                    self._entries[k]["winner"])

        same_shape = [k for k in self._entries
                      if k.pattern == key.pattern and k.ndev == key.ndev
                      and k.ngraphs == key.ngraphs]
        if same_shape:
            best = min(same_shape, key=lambda k: (bucket_dist(k),) + tie(k))
            return self._entries[best]
        same_pattern = [k for k in self._entries if k.pattern == key.pattern]
        if same_pattern:
            best = min(same_pattern,
                       key=lambda k: (bucket_dist(k),
                                      abs(k.ngraphs - key.ngraphs),
                                      abs(k.ndev - key.ndev)) + tie(k))
            return self._entries[best]
        return None

    def resolve(self, key: TuningKey) -> Optional[str]:
        """The winning backend spec for ``key``, or None on a miss."""
        e = self.resolve_entry(key)
        return None if e is None else e["winner"]


def default_table_path() -> str:
    """The committed table, shipped with the package (package data); when
    it is absent ``load_tuning_table(None)`` returns None (``torch-auto``
    falls back)."""
    return str(Path(__file__).resolve().parent / "tuning"
               / f"TUNE_{TABLE_SLUG}.json")


_DEFAULT_CACHE: Dict[str, TuningTable] = {}


def load_tuning_table(path: Optional[str] = None) -> Optional[TuningTable]:
    """Load a tuning table.

    ``path=None`` loads the committed default (cached per process;
    returns None when absent — a checkout that never tuned still
    dispatches, on the fallback).  An *explicit* path must exist and
    validate: pointing ``torch-auto[table=...]`` at a missing or corrupt file
    is a configuration error, not a silent fallback.
    """
    if path is None:
        p = default_table_path()
        if not os.path.exists(p):
            return None
        if p not in _DEFAULT_CACHE:
            _DEFAULT_CACHE[p] = TuningTable(read_tuning_json(p), path=p)
        return _DEFAULT_CACHE[p]
    if not os.path.exists(path):
        raise ValueError(
            f"tuning table {path!r} not found ({AUTO}[table=...] must "
            f"name an existing TUNE_*.json)")
    return TuningTable(read_tuning_json(path), path=path)


# ``device`` is where the winner runs; resolution never reads it
_AUTO_OPTIONS = ("device", "fallback", "table", "timer")


def auto_resolve(spec: str, graphs: Sequence[TaskGraph],
                 ndev: int = 1) -> str:
    """Resolve a ``torch-auto[...]`` spec string to a concrete backend spec.

    Pure table lookup — no backend is instantiated and nothing is
    measured — so ``SyntheticTimer`` calls this with ``ndev=1`` to keep
    the committed baselines machine-independent (the fake clock's model
    is single-device; ``AutoBackend`` itself resolves with the real
    device count).  Other specs pass through unchanged.
    """
    from ..backends.base import parse_backend_spec

    base, kw = parse_backend_spec(spec)
    if base != AUTO:
        return spec
    unknown = sorted(set(kw) - set(_AUTO_OPTIONS))
    if unknown:
        raise ValueError(
            f"backend {AUTO!r} does not accept option {unknown[0]!r}; "
            f"known options: {list(_AUTO_OPTIONS)}")
    timer = kw.get("timer", "synthetic")
    fallback = kw.get("fallback", DEFAULT_FALLBACK)
    table = load_tuning_table(kw.get("table"))
    check_table_timer(table, timer)
    if table is None:
        return fallback
    winner = table.resolve(graphs_cutout(graphs, ndev=ndev))
    return winner if winner is not None else fallback


def check_table_timer(table: Optional[TuningTable], timer: str) -> None:
    """Refuse a table tuned on another timer: wall-clock winners and
    fake-clock winners are different claims."""
    if table is not None and table.timer != timer:
        raise ValueError(
            f"tuning table {table.path or '<default>'} was tuned on timer "
            f"{table.timer!r} but {AUTO} asked for timer={timer!r}; retune "
            f"with `python -m repro_torch.bench.run --tune --timer "
            f"{timer}` or point table= at a matching table")


# ------------------------------------------------------- table diffing

def diff_tuning_tables(baseline: Dict, current: Dict,
                       subset_ok: bool = False,
                       ) -> Tuple[List[str], List[str]]:
    """Diff two tuning tables; returns ``(fatal, notes)``.

    Fatal: timer mismatch (tunings are not comparable), a winner that
    changed at a shared key, and — unless ``subset_ok`` (the reduced
    smoke grid, whose keys are a strict subset of the full grid's) — a
    baseline key missing from the current table.  Notes: subset-skipped
    keys and keys new in the current table (non-fatal, like the bench
    gate's new-in-current scenarios).
    """
    fatal: List[str] = []
    notes: List[str] = []
    bt, ct = baseline.get("timer"), current.get("timer")
    if bt != ct:
        fatal.append(f"timer changed: baseline {bt!r} vs current {ct!r} "
                     f"(tunings are not comparable)")
        return fatal, notes
    base = {TuningKey(**e["key"]): e for e in baseline["entries"]}
    cur = {TuningKey(**e["key"]): e for e in current["entries"]}
    for k in sorted(base, key=key_order):
        ce = cur.get(k)
        if ce is None:
            if subset_ok:
                notes.append(f"tuning key {key_slug(k)} not retuned "
                             f"(reduced grid)")
            else:
                fatal.append(f"tuning key {key_slug(k)} missing from "
                             f"current table")
            continue
        bw, cw = base[k]["winner"], ce["winner"]
        if bw != cw:
            fatal.append(f"winner changed at {key_slug(k)}: baseline "
                         f"{bw!r} -> current {cw!r}")
    for k in sorted(cur, key=key_order):
        if k not in base:
            notes.append(f"tuning key {key_slug(k)} is new in current table")
    return fatal, notes
