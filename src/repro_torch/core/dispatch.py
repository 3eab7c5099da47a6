"""Single source of truth for sparse-operator dispatch.

One registry, keyed by ``(format, op)`` with two implementation tiers:

  * ``"reference"`` — pure-torch semantic oracles (``core/spmv.py``,
    ``partition/hybrid.py`` for the hybrid container), which run on CPU and
    CUDA tensors alike;
  * ``"kernel"``    — hand-written CUDA kernels and their wrappers
    (``kernels/ops.py``).  The kernel tier is always registered: a wrapper
    given a CUDA tensor launches its kernel or raises, and given a CPU
    tensor runs the kernel's plain version.

``op`` is ``"spmv"`` (single right-hand side, ``x: (n_cols,)``) or
``"spmm"`` (multi-RHS panel, ``x: (n_cols, B)``) — the batch-parallel form
that strengthens the paper's amortization rule to
``k * B * (t_crs - t_f) > t_trans``.  Both ops are registered at the
kernel tier for every format the port holds.

Registration happens at import time of the providing modules; lookups lazily
import them, so this module itself has no dependency on any format or kernel
code and there are no import cycles.  A new format or op is registered in
exactly one place: the module that defines its implementations calls
``register_format`` / ``register_impl``.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import obs as _obs

OPS = ("spmv", "spmm")
TIERS = ("reference", "kernel")

# (format, op, tier) -> callable(fmt_obj, x, **kw)
_IMPLS: Dict[Tuple[str, str, str], Callable] = {}
# registration-ordered (name, class, predicate) for format_of()
_FORMAT_TYPES: List[Tuple[str, type, Optional[Callable[[Any], bool]]]] = []

# modules whose import populates the registry, per tier
_PROVIDERS = {
    "reference": ("repro_torch.core.spmv", "repro_torch.partition.hybrid"),
    "kernel": ("repro_torch.core.spmv", "repro_torch.partition.hybrid",
               "repro_torch.kernels.ops"),
}
_loaded: set = set()


def _ensure_loaded(tier: str) -> None:
    for mod in _PROVIDERS[tier]:
        if mod not in _loaded:
            # mark loaded only on success so a failed provider import is
            # retried (and stays loud) instead of silently degrading every
            # later kernel-tier lookup to the reference fallback; re-entry
            # during a provider's own import is safe — import_module
            # returns the in-progress module from sys.modules
            importlib.import_module(mod)
            _loaded.add(mod)


# ---------------------------------------------------------------------------
# registration (called by the providing modules at import time)
# ---------------------------------------------------------------------------
def register_format(name: str, cls: type,
                    predicate: Optional[Callable[[Any], bool]] = None) -> None:
    """Map a container class (optionally narrowed by ``predicate``, e.g. COO
    order) to a format name.  First matching registration wins."""
    _FORMAT_TYPES.append((name, cls, predicate))


def register_impl(fmt: str, op: str, fn: Callable,
                  tier: str = "reference") -> Callable:
    if op not in OPS:
        raise KeyError(f"unknown op {op!r}; one of {OPS}")
    if tier not in TIERS:
        raise KeyError(f"unknown tier {tier!r}; one of {TIERS}")
    _IMPLS[(fmt, op, tier)] = fn
    return fn


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------
def format_of(obj: Any) -> str:
    """Format name of a sparse container instance."""
    _ensure_loaded("reference")
    for name, cls, pred in _FORMAT_TYPES:
        if isinstance(obj, cls) and (pred is None or pred(obj)):
            return name
    raise TypeError(f"unknown sparse format: {type(obj)}")


def resolve_impl(fmt: str, op: str = "spmv", tier: str = "reference",
                 fallback: bool = True) -> Tuple[Callable, str]:
    """Like :func:`get_impl` but also reports which tier actually resolved
    — callers attaching kernel-only arguments (the ``tuning=`` launch
    geometry) must know whether the fallback landed on the reference tier."""
    _ensure_loaded(tier)
    fn = _IMPLS.get((fmt, op, tier))
    found = tier
    if fn is None and fallback and tier != "reference":
        _ensure_loaded("reference")
        fn = _IMPLS.get((fmt, op, "reference"))
        found = "reference"
    if fn is None:
        raise KeyError(f"no {tier} implementation registered for "
                       f"({fmt!r}, {op!r})")
    tel = _obs.get()
    if tel.enabled:
        tel.counter("dispatch.resolve", fmt=fmt, op=op, tier=found).inc()
    return fn, found


def get_impl(fmt: str, op: str = "spmv", tier: str = "reference",
             fallback: bool = True) -> Callable:
    """Implementation for ``(fmt, op)`` at ``tier``.

    ``fallback=True`` lets a missing kernel-tier entry resolve to the
    reference tier (not every (format, op) has a hand-written kernel)."""
    return resolve_impl(fmt, op, tier, fallback)[0]


def has_impl(fmt: str, op: str = "spmv", tier: str = "reference") -> bool:
    _ensure_loaded(tier)
    return (fmt, op, tier) in _IMPLS


def registered_formats(op: Optional[str] = None,
                       tier: str = "reference") -> Tuple[str, ...]:
    """Format names with at least one (or the given op's) registration."""
    _ensure_loaded(tier)
    seen: List[str] = []
    for (f, o, t) in _IMPLS:
        if t == tier and (op is None or o == op) and f not in seen:
            seen.append(f)
    return tuple(seen)


def impl_table(op: str = "spmv", tier: str = "reference",
               fallback: bool = False,
               exclude: Sequence[str] = ()) -> Dict[str, Callable]:
    """``{format: callable}`` view of the registry for one (op, tier).

    With ``fallback=True`` every format known to the reference tier appears,
    kernel entries taking precedence."""
    _ensure_loaded(tier)
    out: Dict[str, Callable] = {}
    if fallback and tier != "reference":
        out.update(impl_table(op, "reference"))
    for (f, o, t), fn in _IMPLS.items():
        if o == op and t == tier and f not in exclude:
            out[f] = fn
    for f in exclude:
        out.pop(f, None)
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def dispatch(obj: Any, x, op: str = "spmv", tier: str = "reference",
             tuning: Any = None, **kw):
    """Resolve ``obj``'s format and apply its ``op`` implementation.

    ``tuning`` is the per-call launch-geometry hint (a
    ``core.kernel_tune.TileGeometry``, or a ``{format: TileGeometry}`` dict
    for the hybrid container); it is forwarded only when the lookup lands
    on the kernel tier — reference implementations have no launch geometry
    and a kernel-tier request may legitimately fall back to one."""
    fn, found = resolve_impl(format_of(obj), op, tier)
    if tuning is not None and found == "kernel":
        kw["tuning"] = tuning
    return fn(obj, x, **kw)


def spmv(m, x, tier: str = "reference", tuning: Any = None):
    return dispatch(m, x, op="spmv", tier=tier, tuning=tuning)


def spmm(m, x, tier: str = "reference", tuning: Any = None):
    if getattr(x, "ndim", 2) != 2:
        raise ValueError(f"spmm expects x of shape (n_cols, B); got "
                         f"{getattr(x, 'shape', None)}")
    return dispatch(m, x, op="spmm", tier=tier, tuning=tuning)


__all__ = ["OPS", "TIERS", "register_format", "register_impl", "format_of",
           "get_impl", "resolve_impl", "has_impl", "registered_formats",
           "impl_table", "dispatch", "spmv", "spmm"]
