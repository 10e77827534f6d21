"""Backend interface and the port's registry.

Counterpart of ``repro.backends.base``, with a registry of its own: the
port's backends never appear in the reference registry.  Each backend
executes a list of concurrent task graphs and returns the final-timestep
payload of each as numpy.  ``prepare`` returns a zero-arg runner that
re-executes the staged workload and blocks until the device is done (its
numpy return copies from the device, which waits for the stream) — the
METG harness times that.

Device rule: a backend runs on ``cuda`` unless its spec asks for another
device (``"torch-scan[device=cpu]"``).  With no device asked for and no
card present, construction raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import ast
import inspect
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from .. import trace
from ..core.graph import TaskGraph

_BACKENDS: Dict[str, Type["Backend"]] = {}

# "name[key=value,key2=value2]" — the declarative backend-spec string.
# ScenarioSpec.backend and the Timer protocol carry a single string, so
# constructor options (device=cpu) must be expressible inside it.
_SPEC_RE = re.compile(r"^([A-Za-z0-9_.-]+)(?:\[(.*)\])?$")


def register_backend(name: str):
    def deco(cls):
        cls.name = name
        _BACKENDS[name] = cls
        return cls

    return deco


def backend_names() -> List[str]:
    return sorted(_BACKENDS)


def parse_backend_spec(spec: str) -> Tuple[str, Dict[str, object]]:
    """Split ``"name[key=value,...]"`` into (name, constructor kwargs).

    Values parse as Python literals (``True``, ``4``, ``1.5``); bare
    words fall back to strings, so ``torch-scan[device=cpu]`` works
    without quoting.  A bare ``"name"`` parses to ``(name, {})``.  The
    kwargs come back sorted by key.
    """
    m = _SPEC_RE.match(spec)
    if m is None:
        raise ValueError(
            f"malformed backend spec {spec!r}; expected "
            f"'name' or 'name[key=value,...]'")
    name, kwstr = m.group(1), m.group(2)
    kwargs: Dict[str, object] = {}
    if kwstr:
        for part in kwstr.split(","):
            part = part.strip()
            if "=" not in part:
                raise ValueError(
                    f"malformed backend option {part!r} in {spec!r}; "
                    f"expected key=value")
            k, v = (s.strip() for s in part.split("=", 1))
            if not k:
                raise ValueError(f"empty option name in backend spec {spec!r}")
            if k in kwargs:
                # a duplicate is always a typo'd spec — the last value
                # silently winning would hide it
                raise ValueError(
                    f"duplicate option {k!r} in backend spec {spec!r}")
            if v.lower() in ("true", "false"):
                # accept the JSON/YAML spellings too: a bare 'false'
                # falling through to the string branch would be truthy
                kwargs[k] = v.lower() == "true"
                continue
            try:
                kwargs[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                kwargs[k] = v  # bare word: a string (cpu, cuda:0, ...)
    return name, dict(sorted(kwargs.items()))


def canonical_backend_spec(spec: str) -> str:
    """The canonical rendering of a backend spec string.

    Parses and re-renders with options sorted by key (bools/numbers in
    Python spelling, strings as bare words), so key-reordered spellings
    of the same spec — ``"x[a=1,b=2]"`` vs ``"x[b=2,a=1]"`` — map to one
    identity.  ``bench.compare`` compares scenario backends through this
    so a reordered baseline never reads as a vanished scenario.
    """
    name, kwargs = parse_backend_spec(spec)
    if not kwargs:
        return name
    opts = ",".join(f"{k}={v}" for k, v in kwargs.items())
    return f"{name}[{opts}]"


def with_options(spec: str, **options) -> str:
    """``spec`` with ``options`` set, in canonical form:
    ``with_options("torch-csp[comm=a2a]", ranks=4)`` ->
    ``"torch-csp[comm=a2a,ranks=4]"``."""
    name, kwargs = parse_backend_spec(spec)
    opts = ",".join(f"{k}={v}" for k, v in {**kwargs, **options}.items())
    return canonical_backend_spec(f"{name}[{opts}]")


def backend_option_signature(name: str) -> Dict[str, object]:
    """The registered backend's constructor options and their defaults."""
    if name not in _BACKENDS:
        raise KeyError(f"unknown backend {name!r}; known: {backend_names()}")
    params = inspect.signature(_BACKENDS[name].__init__).parameters
    return {n: p.default for n, p in params.items()
            if n != "self" and p.kind in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY)}


def _check_ctor_kwargs(name: str, kwargs: Dict) -> None:
    """Reject unknown constructor options, naming backend and key."""
    known = list(backend_option_signature(name))
    for k in kwargs:
        if k not in known:
            raise ValueError(
                f"backend {name!r} does not accept option {k!r}; "
                f"known options: {known if known else 'none'}")


def get_backend(name: str, **kwargs) -> "Backend":
    """Instantiate a backend from a name or spec string.

    Explicit keyword arguments override options embedded in the spec
    string: ``get_backend("torch-scan[device=cpu]", device="cuda")``
    builds a CUDA backend.
    """
    base, spec_kw = parse_backend_spec(name)
    if base not in _BACKENDS:
        raise KeyError(f"unknown backend {base!r}; known: {backend_names()}")
    merged = {**spec_kw, **kwargs}
    _check_ctor_kwargs(base, merged)
    return _BACKENDS[base](**merged)


def resolve_device(device: Optional[str]) -> torch.device:
    """The device a backend runs on: ``cuda`` unless the caller asks."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; ask for the CPU explicitly "
                "(e.g. 'torch-scan[device=cpu]', or device='cpu')")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but no CUDA "
                           f"device is available")
    return dev


class Backend:
    """Executes task graphs. Subclasses implement ``prepare``.

    ``prepare`` runs the graphs *independently*; ``prepare_many`` is the
    concurrent entry point for multi-graph scenarios (paper Fig 9d: task
    parallelism) and defaults to ``prepare``.
    """

    name = "base"
    paradigm = ""  # paper Table 4 analogue, reported by benchmarks
    # deterministic-model hints consumed by bench.timers.SyntheticTimer:
    # how this backend lays a wavefront's tasks over workers
    # (core.schedule policy), and whether it issues the next step's
    # communication ahead of the current kernel body (double buffering)
    sched_policy = "static"
    comm_overlap = False
    # which dispatch-cost model this backend's execution implies:
    # "per-task" — every task pays the runtime's dispatch overhead (the
    # paper's model); "per-launch" — one fixed launch cost for the whole
    # graph batch (the fused kernel).  Each counterpart carries its
    # reference's value.  The timer reads these from the class and the
    # spec's options, never by construction (which needs a card unless
    # the spec asks for the CPU).
    dispatch_model = "per-task"

    def prepare(self, graphs: Sequence[TaskGraph]) -> Callable[[], List[np.ndarray]]:
        """Stage the workload; the returned callable blocks on finish."""
        raise NotImplementedError

    def prepare_many(self, graphs: Sequence[TaskGraph]) -> Callable[[], List[np.ndarray]]:
        """Stage ``graphs`` for *concurrent* execution (default: ``prepare``)."""
        return self.prepare(graphs)

    def run(self, graphs: Sequence[TaskGraph]) -> List[np.ndarray]:
        return self.prepare(graphs)()

    def run_many(self, graphs: Sequence[TaskGraph]) -> List[np.ndarray]:
        """Execute ``graphs`` concurrently; per-graph outputs, same order."""
        return self.prepare_many(graphs)()

    def lowered_programs(self, graphs: Sequence[TaskGraph]
                         ) -> List[Callable[[], object]]:
        """The whole-graph programs ``run_many`` executes, staged, as
        zero-arg callables that run one of them eagerly (the counterpart
        of the reference's ``lowered_hlo``).

        Empty when the backend has no whole-graph program (host dispatch).
        The dry-run timer runs each under ``launch.roofline``'s counter.
        """
        return []


class StackedProgramBackend(Backend):
    """Shared scaffolding for single-device whole-program backends.

    Subclasses provide ``_build(graphs)``, a zero-arg program over staged
    device inputs returning one ``(W, P)`` tensor per graph, and
    ``_build_stacked(graphs)``, a program returning one ``(G, W, P)``
    tensor when the graphs can share a task body (else None).  The
    runners, the numpy return and the concurrent fallback live here so the
    scan, graph and fused backends cannot drift apart.  ``_executable``
    turns a built program into what a runner calls (the program itself
    here; ``cuda-graph`` captures it); a runner keeps that as
    ``runner.program``.

    While ``trace.recording()`` is on, a runner call is a ``run`` span
    holding ``launch`` (the program's call), ``wait`` (until the device
    has finished it) and ``copy`` (to numpy); off, the copy alone waits.
    """

    def __init__(self, device: Optional[str] = None):
        self.device = resolve_device(device)

    def _build(self, graphs: List[TaskGraph]) -> Callable[[], List[torch.Tensor]]:
        raise NotImplementedError

    def _build_stacked(self, graphs: List[TaskGraph]) -> Optional[Callable[[], torch.Tensor]]:
        return None  # no stacked form: prepare_many falls back to prepare

    def _executable(self, program: Callable) -> Callable:
        return program

    def prepare(self, graphs: Sequence[TaskGraph]):
        program = self._executable(self._build(list(graphs)))
        device = self.device

        def runner() -> List[np.ndarray]:
            with trace.span("run"):
                with trace.span("launch"):
                    outs = program()
                trace.wait(device)
                with trace.span("copy"):
                    return [o.cpu().numpy() for o in outs]

        runner.program = program
        return runner

    def prepare_many(self, graphs: Sequence[TaskGraph]):
        graphs = list(graphs)
        built = self._build_stacked(graphs)
        if built is None:
            return self.prepare(graphs)
        program = self._executable(built)
        device = self.device

        def runner() -> List[np.ndarray]:
            with trace.span("run"):
                with trace.span("launch"):
                    out = program()
                trace.wait(device)
                with trace.span("copy"):
                    out = out.cpu().numpy()
                    return [out[k] for k in range(out.shape[0])]

        runner.program = program
        return runner

    def lowered_programs(self, graphs: Sequence[TaskGraph]
                         ) -> List[Callable[[], object]]:
        """The built program, uncaptured: the stacked one, else one over
        the graphs."""
        graphs = list(graphs)
        built = self._build_stacked(graphs)
        return [built if built is not None else self._build(graphs)]
