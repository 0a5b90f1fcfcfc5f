"""Typed compiler configuration: :class:`CompileOptions` + named profiles.

One frozen dataclass absorbs every tuning knob that used to travel as loose
``map_dfg`` kwargs and untyped service dicts (DESIGN.md §11). The same object
configures single-shot compiles, the batch service, and window racing, so
policy lives in exactly one place:

* **Profiles** — :data:`PROFILES` maps a name (``fast``, ``quality``,
  ``deterministic-ci``, ``default``) to a fully-populated options value;
  :func:`resolve_options` starts from a profile and applies explicit
  overrides, which is the only resolution path the CLIs use.
* **CLI flags are defined once** — :func:`add_cli_args` installs the shared
  option flags on any argparse parser and :func:`options_from_args` turns the
  parsed namespace back into a resolved :class:`CompileOptions`; the
  ``repro_torch.compile`` CLI, ``benchmarks/run.py`` and both examples all go
  through this pair.
* **JSON round-trip** — ``to_json``/``from_json`` serialise every field and
  reject unknown keys, so a report's embedded options block can be replayed
  byte-for-byte.

This module deliberately imports nothing from the rest of ``repro_torch`` at module
level: ``core/mapper.py``'s compatibility shim builds a ``CompileOptions``
lazily, and a stdlib-only module can never close an import cycle.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, fields

__all__ = [
    "CompileOptions",
    "PROFILES",
    "add_cli_args",
    "options_from_args",
    "resolve_options",
]

#: Fields forwarded verbatim to the portfolio mapper
#: (:func:`repro_torch.core.mapper.map_dfg`). Order matches the historical kwarg
#: order for readability; the parity test pins the set itself.
MAPPER_FIELDS = (
    "max_ii",
    "max_slack",
    "connectivity",
    "backend",
    "space_backend",
    "time_budget_s",
    "space_timeout_s",
    "space_polish_timeout_s",
    "space_timeout_growth",
    "det_space_cap",
    "max_retries_per_window",
    "window_timeout_s",
    "max_register_pressure",
    "max_route_hops",
    "deterministic",
    "use_cache",
    "cache_dir",
    "window_offset",
    "window_stride",
    "seed",
)

#: Service-layer knobs (batch pool + racing) that never reach ``map_dfg``.
SERVICE_FIELDS = ("jobs", "deadline_s", "racing_workers")

_CONNECTIVITIES = ("strict", "paper")
_BACKENDS = ("auto", "cp", "cp-inc", "python", "z3")
_SPACE_BACKENDS = ("auto", "exact", "anneal")


@dataclass(frozen=True)
class CompileOptions:
    """Frozen, JSON-round-trippable compiler configuration (DESIGN.md §11).

    Field defaults are exactly the historical ``map_dfg`` defaults, so
    ``CompileOptions()`` reproduces a bare ``map_dfg(dfg, cgra)`` call.

    Example — resolve a profile, tighten one knob, and round-trip it::

        from repro_torch.api import CompileOptions, resolve_options

        opts = resolve_options("fast", max_slack=1)
        assert opts.profile == "fast" and opts.max_slack == 1
        again = CompileOptions.from_json(opts.to_json())
        assert again == opts

    Unknown keys are rejected on every construction path: the dataclass
    ``__init__`` raises ``TypeError``, ``from_json``/``from_dict`` raise
    ``ValueError`` naming the offending keys.
    """

    # ------------------------------------------------------- search shape
    max_ii: int | None = None           # sweep upper bound (None = default_max_ii)
    max_slack: int = 3                  # slack depth of the (II, slack) sweep
    connectivity: str = "strict"        # "strict" | "paper" (DESIGN.md §7)
    backend: str = "auto"               # time backend: auto | cp | z3
    space_backend: str = "auto"         # space backend: auto | exact | anneal (§13)
    seed: int = 0                       # search diversification seed
    # ------------------------------------------------------------ budgets
    time_budget_s: float = 120.0        # total wall budget per compile
    space_timeout_s: float = 0.6        # per space-probe wall cap
    space_polish_timeout_s: float = 2.5  # polish-dive wall cap floor
    space_timeout_growth: float = 1.0   # per-round probe-cap growth factor
    det_space_cap: int = 400_000        # per-round space-node cap (deterministic)
    max_retries_per_window: int = 8     # pending-partition retry width
    window_timeout_s: float = 10.0      # per time-solver-call wall cap
    # -------------------------------------------------------- constraints
    max_register_pressure: int | None = None   # per-PE effective bound: min(this, registers_at(pe))
    max_route_hops: int = 0             # route-through mov budget per edge (0 = direct only)
    # -------------------------------------------------------- determinism
    deterministic: bool = False         # step-budgeted reproducible mode (§6.3)
    # ------------------------------------------------------- cache policy
    use_cache: bool = True              # both mapping-cache layers
    cache_dir: str | None = None        # persistent layer (None = $REPRO_CACHE_DIR)
    # ---------------------------------------------------- window striping
    window_offset: int = 0              # this worker's stripe (service racing)
    window_stride: int = 1              # stripe count
    # ------------------------------------------------------ observability
    trace: bool = False                 # structured span tracing (repro_torch.obs, §15)
    # ------------------------------------------------------ service knobs
    jobs: int | None = None             # batch workers (None = os.cpu_count())
    deadline_s: float | None = None     # per-job wall budget in compile_batch
    racing_workers: int = 1             # compile_racing default worker count
    tenant: str | None = None           # daemon tenant label (provenance, §16)
    # ------------------------------------------------- exact certification
    exact_check: bool = False           # certify/improve each result (§14)
    exact_budget_s: float = 20.0        # wall budget per certification sweep
    # ----------------------------------------------------------- target
    arch: str | None = None             # preset name or ArchSpec JSON path
    # -------------------------------------------------------- provenance
    profile: str | None = None          # profile this value was resolved from

    # ------------------------------------------------------------ validation
    def validate(self) -> None:
        """Raise ValueError on a statically-invalid combination.

        Mapper-internal checks (e.g. ``deterministic`` × z3) stay in the
        mapper — this only rejects what no call could ever accept.
        """
        if self.connectivity not in _CONNECTIVITIES:
            raise ValueError(
                f"connectivity must be one of {_CONNECTIVITIES}, "
                f"got {self.connectivity!r}"
            )
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}"
            )
        if self.space_backend not in _SPACE_BACKENDS:
            raise ValueError(
                f"space_backend must be one of {_SPACE_BACKENDS}, "
                f"got {self.space_backend!r}"
            )
        if self.space_timeout_s <= 0 or self.space_polish_timeout_s <= 0:
            raise ValueError("space timeouts must be > 0")
        if self.space_timeout_growth < 0:
            raise ValueError("space_timeout_growth must be >= 0")
        if self.det_space_cap < 1:
            raise ValueError(f"det_space_cap must be >= 1, got {self.det_space_cap}")
        if self.max_slack < 0:
            raise ValueError(f"max_slack must be >= 0, got {self.max_slack}")
        if self.max_route_hops < 0:
            raise ValueError(
                f"max_route_hops must be >= 0, got {self.max_route_hops}"
            )
        if self.max_ii is not None and self.max_ii < 1:
            raise ValueError(f"max_ii must be >= 1, got {self.max_ii}")
        if self.time_budget_s <= 0:
            raise ValueError("time_budget_s must be > 0")
        if self.window_stride < 1 or not (0 <= self.window_offset < self.window_stride):
            raise ValueError(
                f"invalid window striping: offset {self.window_offset}, "
                f"stride {self.window_stride}"
            )
        if self.jobs is not None and self.jobs < 1:
            raise ValueError(f"jobs must be >= 1 (or None = auto), got {self.jobs}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0 (or None)")
        if self.racing_workers < 1:
            raise ValueError("racing_workers must be >= 1")
        if self.exact_budget_s <= 0:
            raise ValueError("exact_budget_s must be > 0")
        if self.profile is not None and self.profile not in PROFILES:
            raise ValueError(
                f"unknown profile {self.profile!r} "
                f"(choose from {', '.join(sorted(PROFILES))})"
            )

    # -------------------------------------------------------------- projection
    def replace(self, **changes) -> "CompileOptions":
        """A copy with ``changes`` applied (unknown keys raise TypeError)."""
        return dataclasses.replace(self, **changes)

    def mapper_kwargs(self, *, exclude: tuple[str, ...] = ()) -> dict:
        """The exact kwarg dict :func:`repro_torch.core.mapper.map_dfg` accepts.

        ``exclude`` drops fields the caller owns — e.g. racing strips the
        striping fields because it assigns stripes per worker itself.
        """
        return {
            f: getattr(self, f) for f in MAPPER_FIELDS if f not in exclude
        }

    def batch_kwargs(self) -> dict:
        """Per-job ``map_dfg`` kwargs for the batch service.

        ``deadline_s`` (when set, non-deterministic) replaces the per-job
        ``time_budget_s`` — the service contract: a job's wall budget is its
        deadline, enforced inside the worker (DESIGN.md §8.1).
        """
        kw = self.mapper_kwargs()
        if self.deadline_s is not None and not self.deterministic:
            kw["time_budget_s"] = self.deadline_s
        return kw

    # ------------------------------------------------------------------- I/O
    def as_dict(self) -> dict:
        """All fields as a JSON-compatible dict (the report embedding)."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def to_json(self) -> str:
        return json.dumps(self.as_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "CompileOptions":
        """Build from a dict, rejecting unknown keys (missing keys default)."""
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(
                f"unknown CompileOptions keys: {', '.join(unknown)}"
            )
        opts = cls(**d)
        opts.validate()
        return opts

    @classmethod
    def from_json(cls, text: str) -> "CompileOptions":
        try:
            d = json.loads(text)
        except ValueError as exc:
            raise ValueError(f"malformed CompileOptions JSON: {exc}") from None
        if not isinstance(d, dict):
            raise ValueError("malformed CompileOptions JSON: not an object")
        return cls.from_dict(d)


# ------------------------------------------------------------------ profiles

#: Named option profiles. ``default`` mirrors the historical ``map_dfg``
#: defaults; ``fast`` trades II quality for latency (interactive / premap
#: warm-up); ``quality`` spends a long budget polishing toward mII;
#: ``deterministic-ci`` is the load-independent reproducible mode CI runs
#: (step budgets, no caches, sequential batch); ``certify`` is ``default``
#: plus the exact joint optimality sweep on every result (DESIGN.md §14).
PROFILES: dict[str, CompileOptions] = {
    "default": CompileOptions(profile="default"),
    "fast": CompileOptions(
        profile="fast",
        time_budget_s=20.0,
        max_slack=2,
        window_timeout_s=5.0,
        max_retries_per_window=4,
    ),
    "quality": CompileOptions(
        profile="quality",
        time_budget_s=300.0,
        max_slack=4,
        window_timeout_s=20.0,
    ),
    "deterministic-ci": CompileOptions(
        profile="deterministic-ci",
        deterministic=True,
        use_cache=False,
        backend="cp",
        jobs=1,
    ),
    "certify": CompileOptions(
        profile="certify",
        exact_check=True,
    ),
}


def resolve_options(profile: str | None = None, **overrides) -> CompileOptions:
    """THE options-resolution path: profile defaults + explicit overrides.

    Every CLI resolves its flags through this function (via
    :func:`options_from_args`), so a flag's meaning cannot drift between
    frontends. Unknown override keys raise TypeError (dataclass ``replace``),
    invalid values raise ValueError (:meth:`CompileOptions.validate`).
    """
    if profile is None:
        base = PROFILES["default"].replace(profile=None)
    else:
        try:
            base = PROFILES[profile]
        except KeyError:
            raise ValueError(
                f"unknown profile {profile!r} "
                f"(choose from {', '.join(sorted(PROFILES))})"
            ) from None
    opts = base.replace(**overrides) if overrides else base
    opts.validate()
    return opts


# ----------------------------------------------------------------- CLI glue

#: Flags installed by :func:`add_cli_args`; each maps 1:1 to an options field.
#: ``None`` in the parsed namespace means "not given → profile value wins".
_CLI_FIELDS = (
    "max_ii",
    "max_slack",
    "connectivity",
    "backend",
    "space_backend",
    "seed",
    "time_budget_s",
    "max_register_pressure",
    "max_route_hops",
    "deterministic",
    "use_cache",
    "cache_dir",
    "jobs",
    "deadline_s",
    "arch",
    "exact_check",
    "exact_budget_s",
)


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    """Install the shared compiler-option flags on ``parser``.

    This is the single definition of the flag set: ``repro_torch.compile``,
    ``benchmarks/run.py`` and both examples call this instead of re-declaring
    flags by hand. Pair with :func:`options_from_args`.
    """
    g = parser.add_argument_group("compiler options (repro_torch.api)")
    g.add_argument("--profile", choices=sorted(PROFILES), default=None,
                   help="named options profile; explicit flags override it")
    g.add_argument("--max-ii", type=int, default=None, dest="max_ii",
                   help="upper II bound of the sweep")
    g.add_argument("--max-slack", type=int, default=None, dest="max_slack",
                   help="slack depth of the (II, slack) sweep")
    g.add_argument("--connectivity", choices=list(_CONNECTIVITIES),
                   default=None)
    g.add_argument("--backend", choices=list(_BACKENDS), default=None,
                   help="time backend")
    g.add_argument("--space-backend", choices=list(_SPACE_BACKENDS),
                   default=None, dest="space_backend",
                   help="space (placement) backend: exact bitset search, "
                        "anneal clustered placement, or auto (fabric-sized)")
    g.add_argument("--seed", type=int, default=None,
                   help="search diversification seed")
    g.add_argument("--time-budget-s", type=float, default=None,
                   dest="time_budget_s", help="wall budget per compile")
    g.add_argument("--max-register-pressure", type=int, default=None,
                   dest="max_register_pressure",
                   help="reject mappings exceeding min(this, registers_at(pe)) "
                        "live values on any PE")
    g.add_argument("--max-route-hops", type=int, default=None,
                   dest="max_route_hops",
                   help="allow routing a dataflow edge through up to this many "
                        "intermediate mov PEs when no direct embedding exists "
                        "(default 0 = paper behaviour)")
    g.add_argument("--deterministic", action="store_true", default=None,
                   help="step-budgeted reproducible mode (bypasses caches)")
    g.add_argument("--no-cache", action="store_false", default=None,
                   dest="use_cache", help="disable both mapping cache layers")
    g.add_argument("--cache-dir", default=None, dest="cache_dir",
                   help="persistent mapping cache directory "
                        "(default: $REPRO_CACHE_DIR if set)")
    g.add_argument("--jobs", type=int, default=None,
                   help="batch worker processes (default: all cores)")
    g.add_argument("--deadline-s", type=float, default=None, dest="deadline_s",
                   help="per-job wall budget in batch compiles")
    g.add_argument("--arch", metavar="PRESET|FILE.json", default=None,
                   help="architecture spec: a named preset "
                        "(repro_torch.core.arch.presets) or an ArchSpec JSON file")
    g.add_argument("--exact-check", action="store_true", default=None,
                   dest="exact_check",
                   help="run the exact joint backend after each compile: "
                        "prove the II optimal or adopt a strictly better "
                        "mapping, and attach the certificate (DESIGN.md §14)")
    g.add_argument("--exact-budget-s", type=float, default=None,
                   dest="exact_budget_s",
                   help="wall budget per certification sweep (default 20)")
    g.add_argument("--trace", metavar="OUT.json", default=None,
                   dest="trace_out",
                   help="record structured compile-pipeline spans and write "
                        "a Perfetto-loadable Chrome trace-event JSON file "
                        "(summarize with tools/trace_report.py; DESIGN.md §15)")


def options_from_args(args: argparse.Namespace) -> CompileOptions:
    """Resolve a parsed namespace into options via :func:`resolve_options`.

    Only flags the user actually passed override the profile; everything
    else keeps the profile's value.
    """
    overrides = {
        f: getattr(args, f)
        for f in _CLI_FIELDS
        if getattr(args, f, None) is not None
    }
    # --trace OUT.json both enables tracing and names the output file; the
    # path itself stays CLI-side (args.trace_out) — options only carry the
    # enable bit so the field stays JSON-round-trippable.
    if getattr(args, "trace_out", None):
        overrides["trace"] = True
    return resolve_options(getattr(args, "profile", None), **overrides)
