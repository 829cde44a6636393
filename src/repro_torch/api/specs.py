"""The declarative experiment description (twin of repro.api.specs).

The spec tree and its JSON layout are the JAX package's, field for field, so
a spec file written by `repro` loads here (`spec_from_dict`, strict on
unknown keys).  Validation runs in two steps: the JAX package's own checks
(unknown registry entries and options, out-of-range knobs, a byte budget
on an engine that cannot gate -> SpecError), then this port's limits:
every field whose feature is not ported yet raises NotPortedError naming
the ROADMAP item it waits for — never silently ignored.
`TransportSpec.resolve(d)` builds the run's `transport.Transport`.  BackendSpec's Monte-Carlo knobs (trial_devices, compute_dtype,
donate) are read by batch_fit only, in the JAX package as here.

`FaultSpec` is repro_torch.faults' (the JAX package's fields and checks);
`resolved_transport()` rides it on the run's Transport.  `ObsSpec` is
repro_torch.obs' (the taps of the icoa solver: an unknown tap, or taps on
another solver, is a SpecError).  `StreamSpec` describes an online run
(repro_torch.stream), with the JAX package's checks and dict layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.agents import FAMILIES
from repro_torch.analysis import sanitize
from repro_torch.core.icoa import ICOAConfig, NotPortedError
from repro_torch.data import sources as data_sources
from repro_torch.data.partition import PARTITIONS, make_groups, validate_partition
from repro_torch.data.sources import SOURCES
from repro_torch.faults.spec import FaultError, FaultSpec
from repro_torch.obs.spec import ObsError, ObsSpec
from repro_torch import transport as transport_lib
from repro_torch.transport import CODECS, POLICIES, TOPOLOGIES, TransportError

__all__ = [
    "DataSpec", "AgentSpec", "SolverSpec", "BackendSpec", "TransportSpec",
    "FaultSpec", "FaultError", "ObsSpec", "ObsError", "ExperimentSpec",
    "StreamSpec", "Dataset", "SpecError", "NotPortedError", "spec_to_dict",
    "spec_from_dict", "stream_spec_to_dict", "stream_spec_from_dict",
]

_SOLVERS = ("icoa", "averaging", "residual_refitting")
_BACKENDS = ("local", "shard_map")
_COMPUTE_DTYPES = ("bfloat16", "float32", "float64")


class SpecError(ValueError):
    """A spec field refers to an unknown registry entry or is inconsistent."""


class SpecNotPortedError(SpecError, NotPortedError):
    """A valid spec field whose feature this port does not implement yet."""


class Dataset(NamedTuple):
    """Materialised data, already partitioned into per-agent column stacks."""

    xcols: torch.Tensor        # (D, N_train, C) agent column views
    y: torch.Tensor            # (N_train,)
    xcols_test: torch.Tensor   # (D, N_test, C)
    y_test: torch.Tensor       # (N_test,)
    groups: List[List[int]]    # attribute partition (agent i -> column indices)


def _not_ported(what: str, item: str) -> SpecNotPortedError:
    return SpecNotPortedError(f"{what} is not ported to repro_torch yet: it "
                              f"waits for ROADMAP {item}")


@dataclasses.dataclass(frozen=True)
class DataSpec:
    source: str = "friedman1"
    n_train: int = 2000
    n_test: int = 2000
    noise: float = 0.0
    seed: int = 0
    n_attrs: Optional[int] = None
    source_options: Tuple[Tuple[str, Any], ...] = ()
    partition: str = "one_per_agent"
    n_agents: Optional[int] = None
    partition_options: Tuple[Tuple[str, Any], ...] = ()

    def _source(self):
        src = SOURCES.get(self.source)
        if src is None:
            raise SpecError(f"unknown data source {self.source!r}; "
                            f"registered: {sorted(SOURCES)}")
        return src

    @property
    def resolved_n_attrs(self) -> int:
        try:
            return self._source().resolve_n_attrs(self.n_attrs)
        except SpecError:
            raise
        except ValueError as e:
            raise SpecError(str(e)) from None

    @property
    def resolved_n_agents(self) -> int:
        return self.resolved_n_attrs if self.n_agents is None else self.n_agents

    def validate(self) -> None:
        src = self._source()
        if self.partition not in PARTITIONS:
            raise SpecError(f"unknown partition {self.partition!r}; "
                            f"registered: {sorted(PARTITIONS)}")
        for label, opts, known in (
                ("source", self.source_options, src.options),
                ("partition", self.partition_options,
                 PARTITIONS[self.partition].options)):
            for name, _ in opts:
                if name not in known:
                    raise SpecError(f"{label} {getattr(self, label)!r} has no "
                                    f"option {name!r}; valid: {sorted(known)}")
        if self.n_train < 2 or self.n_test < 1:
            raise SpecError("need n_train >= 2 and n_test >= 1")
        groups = self.groups
        if len({len(g) for g in groups}) > 1:
            raise SpecError(
                f"partition {self.partition!r} with n_attrs="
                f"{self.resolved_n_attrs}, n_agents={self.resolved_n_agents} "
                f"gives unequal group sizes {[len(g) for g in groups]}; the "
                f"stacked runtime needs every agent to hold the same number "
                f"of columns — pick n_agents dividing n_attrs")
        try:
            validate_partition(groups, self.resolved_n_attrs)
        except ValueError as e:
            raise SpecError(str(e)) from None

    @property
    def groups(self) -> List[List[int]]:
        try:
            return make_groups(self.partition, self.resolved_n_attrs,
                               self.resolved_n_agents,
                               options=self.partition_options)
        except SpecError:
            raise
        except (TypeError, ValueError) as e:
            raise SpecError(f"partition {self.partition!r}: {e}") from None

    def build(self, device="cpu") -> Dataset:
        """Draw on `device` from `seed` (the JAX package's key stream, in
        torch's default float dtype), standardise and partition."""
        self.validate()
        groups = self.groups
        xtr, ytr, xte, yte = data_sources.make_dataset(
            self.source, self.n_train, self.n_test, self.seed,
            noise=self.noise, n_attrs=self.n_attrs,
            options=self.source_options, device=device)
        return Dataset(data_sources.partition_columns(xtr, groups), ytr,
                       data_sources.partition_columns(xte, groups), yte,
                       groups)


@dataclasses.dataclass(frozen=True)
class AgentSpec:
    family: str = "polynomial"
    options: Tuple[Tuple[str, Any], ...] = ()

    def validate(self) -> None:
        if self.family not in FAMILIES:
            raise SpecError(f"unknown agent family {self.family!r}; "
                            f"registered: {sorted(FAMILIES)}")
        fields = {f.name for f in dataclasses.fields(FAMILIES[self.family])} - {"n_cols"}
        for name, _ in self.options:
            if name not in fields:
                raise SpecError(f"family {self.family!r} has no option "
                                f"{name!r}; valid: {sorted(fields)}")

    def resolve(self, n_cols: int):
        self.validate()
        return FAMILIES[self.family](n_cols=n_cols, **dict(self.options))


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str = "icoa"
    n_sweeps: int = 10
    eps: float = 1e-7
    alpha: float = 1.0
    delta: float = 0.0
    engine: str = "incremental"
    row_broadcast: bool = False  # dense engine only; incremental/fused are row-wise
    use_kernel: bool = False    # route the products through the CUDA kernels
    accept_reject: bool = True
    step0: float = 1.0
    backtrack: float = 0.5
    max_probes: int = 16
    minimax_steps: int = 300
    minimax_lr: float = 0.05

    def validate(self) -> None:
        if self.name not in _SOLVERS:
            raise SpecError(f"unknown solver {self.name!r}; pick one of {_SOLVERS}")
        if self.alpha < 1.0:
            raise SpecError(f"alpha is a compression RATE, must be >= 1 "
                            f"(got {self.alpha})")
        if self.delta < 0.0:
            raise SpecError(f"delta must be >= 0 (got {self.delta})")
        if self.n_sweeps < 1:
            raise SpecError("need n_sweeps >= 1")
        if self.engine not in ("dense", "incremental", "fused"):
            raise SpecError(f"unknown engine {self.engine!r}; pick 'dense', "
                            f"'incremental' or 'fused'")

    def icoa_config(self, transport=None, checks: str = "off",
                    obs=None) -> ICOAConfig:
        """`transport` the resolved Transport (None: the exact_f64 / full
        default), `checks` the backend's sanitizer mode (BackendSpec.checks),
        `obs` the normalized ObsSpec (None: no taps)."""
        return ICOAConfig(
            n_sweeps=self.n_sweeps, eps=self.eps, step0=self.step0,
            backtrack=self.backtrack, max_probes=self.max_probes,
            alpha=self.alpha, delta=self.delta,
            minimax_steps=self.minimax_steps, minimax_lr=self.minimax_lr,
            use_kernel=self.use_kernel, accept_reject=self.accept_reject,
            row_broadcast=self.row_broadcast, engine=self.engine,
            transport=transport, checks=checks, obs=obs)


@dataclasses.dataclass(frozen=True)
class TransportSpec:
    """The communication regime of a run: `topology` and `codec` name the
    transport registries (options as tuple-of-pairs), `byte_budget` caps
    the run's measured wire bytes, spent in `policy` order (greedy_eta:
    the most promising cached-probe rows first; truncate: round-robin)."""

    topology: str = "full"
    topology_options: Tuple[Tuple[str, Any], ...] = ()
    codec: str = "exact_f64"
    codec_options: Tuple[Tuple[str, Any], ...] = ()
    byte_budget: Optional[float] = None
    policy: str = "greedy_eta"

    def validate(self) -> None:
        if self.topology not in TOPOLOGIES:
            raise SpecError(f"unknown topology {self.topology!r}; "
                            f"registered: {sorted(TOPOLOGIES)}")
        if self.codec not in CODECS:
            raise SpecError(f"unknown codec {self.codec!r}; "
                            f"registered: {sorted(CODECS)}")
        for label, opts, known in (
                ("topology", self.topology_options,
                 TOPOLOGIES[self.topology].options),
                ("codec", self.codec_options, CODECS[self.codec].options)):
            for name, _ in opts:
                if name not in known:
                    raise SpecError(
                        f"{label} {getattr(self, label)!r} has no option "
                        f"{name!r}; valid: {sorted(known)}")
        if self.policy not in POLICIES:
            raise SpecError(f"unknown budget policy {self.policy!r}; "
                            f"pick one of {POLICIES}")
        if self.byte_budget is not None and not (
                math.isfinite(self.byte_budget) and self.byte_budget > 0):
            raise SpecError(f"byte_budget must be positive and finite (got "
                            f"{self.byte_budget}); use None for unbudgeted")

    def resolve(self, n_agents: int) -> transport_lib.Transport:
        """The Transport of a D-agent run (graph tables, codec, budget)."""
        self.validate()
        if self == TransportSpec():
            return transport_lib.default_transport(n_agents)
        try:
            topo = transport_lib.build_topology(
                self.topology, n_agents, options=self.topology_options)
            codec = transport_lib.build_codec(self.codec,
                                              options=self.codec_options)
            return transport_lib.Transport(topology=topo, codec=codec,
                                           byte_budget=self.byte_budget,
                                           policy=self.policy)
        except (TransportError, TypeError) as e:
            # TypeError: a wrong-typed option value (names are checked above)
            raise SpecError(f"transport: {e}") from None


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str = "local"
    n_devices: Optional[int] = None
    trial_devices: Optional[int] = None
    compute_dtype: Optional[str] = None
    donate: bool = True
    checks: str = "off"

    def validate(self) -> None:
        if self.name not in _BACKENDS:
            raise SpecError(f"unknown backend {self.name!r}; pick one of {_BACKENDS}")
        try:
            sanitize.validate_mode(self.checks, "BackendSpec.checks")
        except ValueError as e:
            raise SpecError(str(e)) from None
        if self.trial_devices is not None and self.trial_devices < 1:
            raise SpecError(f"trial_devices must be >= 1 (got {self.trial_devices})")
        if self.name == "shard_map" and self.trial_devices is not None:
            raise SpecError(
                "trial_devices shards the trial axis of the LOCAL backend; "
                "the shard_map backend devotes the whole agent group to each "
                "trial (n_devices sizes it) — the knob would be silently "
                "ignored")
        if self.compute_dtype is not None and self.compute_dtype not in _COMPUTE_DTYPES:
            raise SpecError(f"unknown compute_dtype {self.compute_dtype!r}; "
                            f"pick one of {list(_COMPUTE_DTYPES)}")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    data: DataSpec = DataSpec()
    agent: AgentSpec = AgentSpec()
    solver: SolverSpec = SolverSpec()
    backend: BackendSpec = BackendSpec()
    transport: TransportSpec = TransportSpec()
    faults: FaultSpec = FaultSpec()
    obs: ObsSpec = ObsSpec()
    seed: int = 0

    def validate(self) -> None:
        self.data.validate()
        self.agent.validate()
        self.solver.validate()
        self.backend.validate()
        self.transport.validate()
        try:
            self.obs.validate()
        except ObsError as e:
            raise SpecError(f"obs: {e}") from None
        if self.obs.enabled and self.solver.name != "icoa":
            raise SpecError(
                "obs taps are collected inside the ICOA sweep; solver {!r} "
                "has no sweep to tap (averaging and the refit ring record "
                "only their History)".format(self.solver.name))
        if self.transport.byte_budget is not None:
            if (self.solver.name != "icoa"
                    or self.solver.engine not in ("incremental", "fused")):
                raise SpecError(
                    "byte_budget schedules gate per-row broadcasts off the "
                    "carried CovState — they need solver 'icoa' with "
                    "engine='incremental' or 'fused' (averaging transmits "
                    "nothing; the refit ring and the dense oracle have no "
                    "per-row broadcast to skip)")
        try:
            self.faults.validate()
        except FaultError as e:
            raise SpecError(f"faults: {e}") from None
        if not self.faults.is_inert:
            # in lockstep with faults.require_fault_engine, naming the fields
            if (self.solver.name != "icoa"
                    or self.solver.engine not in ("incremental", "fused")):
                raise SpecError(
                    "fault injection gates per-row broadcasts inside the "
                    "carried-CovState sweep — it needs solver 'icoa' with "
                    "engine='incremental' or 'fused' (averaging transmits "
                    "nothing; the refit ring and the dense oracle re-transmit "
                    "everything by construction)")
            if self.faults.crash and self.solver.delta > 0.0:
                raise SpecError(
                    "faults.crash re-weights the ensemble over the survivors "
                    "(a masked closed form); the minimax-protected weights "
                    "(delta > 0) have no masked closed form — run crash "
                    "schedules with delta=0")
            n_agents = self.data.resolved_n_agents
            for agent, _, _ in self.faults.crash:
                if agent >= n_agents:
                    raise SpecError(
                        f"faults.crash names agent {agent} but the run has "
                        f"{n_agents} agents")

    def resolved_transport(self):
        """The run's Transport (TransportSpec.resolve at its agent count)
        with the spec's FaultSpec riding on it (an inert one resolves to
        the reliable wire)."""
        tp = self.transport.resolve(self.data.resolved_n_agents)
        if self.faults.is_inert:
            return tp
        return dataclasses.replace(tp, faults=self.faults)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """The online run description (the JAX package's): instances arrive in
    `chunk`-sized micro-batches into a `window`-instance ring; every
    `resweep_every` instances `sweeps_per_resweep` ICOA sweeps run on the
    warm window and emit a history record; predictions are scored
    prequentially (each chunk before it is ingested).  `experiment` is the
    scenario template (its n_train / n_test are not read).  `drift_option`
    names a source option drifting linearly from `drift_start` to
    `drift_end` over the stream; `checkpoint_every` (with stream_fit's
    directory) saves the live state every that many instances;
    `serve_buckets` are PredictEngine's batch sizes."""

    experiment: ExperimentSpec = ExperimentSpec()
    window: int = 2048            # ring-buffer capacity
    chunk: int = 64               # arrival micro-batch size
    total_instances: int = 100_000
    resweep_every: int = 2048     # instances between cadenced re-sweeps
    sweeps_per_resweep: int = 1
    drift_option: Optional[str] = None   # source option that drifts over time
    drift_start: float = 0.0
    drift_end: float = 0.0
    checkpoint_every: Optional[int] = None   # instances between state saves
    serve_buckets: Tuple[int, ...] = (1, 16, 128)  # PredictEngine batch sizes

    def validate(self) -> None:
        self.experiment.validate()
        sol = self.experiment.solver
        if sol.name != "icoa":
            raise SpecError(
                f"streaming re-sweeps drive icoa on the warm window; solver "
                f"{sol.name!r} has no sweep to cadence")
        if sol.alpha != 1.0 or sol.delta != 0.0:
            raise SpecError(
                "the warm stream CovState tracks the full window residuals "
                "(alpha=1) and serves closed-form live weights (delta=0); "
                "Minimax Protection knobs are an offline-path feature")
        if self.experiment.backend.name != "local":
            raise SpecError("stream_fit runs the local backend only (the "
                            "ingest/serve loop is a single-process engine)")
        for name, val in (("window", self.window), ("chunk", self.chunk),
                          ("total_instances", self.total_instances),
                          ("resweep_every", self.resweep_every),
                          ("sweeps_per_resweep", self.sweeps_per_resweep)):
            if val < 1:
                raise SpecError(f"need {name} >= 1, got {val}")
        # a chunk never straddles the ring's wrap point
        for name, val in (("window", self.window),
                          ("total_instances", self.total_instances),
                          ("resweep_every", self.resweep_every)):
            if val % self.chunk != 0:
                raise SpecError(
                    f"{name}={val} must be a multiple of chunk={self.chunk} "
                    f"(static-shape ring arithmetic)")
        if self.checkpoint_every is not None \
                and self.checkpoint_every % self.chunk != 0:
            raise SpecError(
                f"checkpoint_every={self.checkpoint_every} must be a "
                f"multiple of chunk={self.chunk}")
        if not self.serve_buckets or \
                any(b < 1 for b in self.serve_buckets):
            raise SpecError("serve_buckets needs at least one positive "
                            "batch size")
        if self.drift_option is not None:
            src = SOURCES[self.experiment.data.source]
            if self.drift_option not in src.options:
                raise SpecError(
                    f"source {src.name!r} has no option "
                    f"{self.drift_option!r} to drift; valid: "
                    f"{sorted(src.options)}")


# ------------------------------------------------------------- serialisation


def spec_to_dict(spec: ExperimentSpec) -> Dict[str, Any]:
    return dataclasses.asdict(spec)


def _checked_fields(cls, d: Dict[str, Any], where: str) -> Dict[str, Any]:
    allowed = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - allowed)
    if unknown:
        raise SpecError(f"unrecognised field(s) in {where}: {unknown}; "
                        f"valid fields: {sorted(allowed)}")
    return dict(d)


def _pairs(value, where: str) -> Tuple[Tuple[str, Any], ...]:
    # JSON turns tuple-of-pairs into list-of-lists; restore it
    if isinstance(value, (str, bytes)) or not hasattr(value, "__iter__"):
        raise SpecError(f"{where} must be a sequence of [name, value] pairs "
                        f"(got {value!r})")
    out = []
    for pos, item in enumerate(value):
        try:
            k, v = item
        except (TypeError, ValueError):
            raise SpecError(f"{where}[{pos}] is not a [name, value] pair "
                            f"(got {item!r})") from None
        out.append((str(k), v))
    return tuple(out)


def _crash_entries(value, where: str) -> Tuple[Tuple[int, int, int], ...]:
    if isinstance(value, (str, bytes)) or not hasattr(value, "__iter__"):
        raise SpecError(f"{where} must be a sequence of [agent, down_round, "
                        f"rejoin_round] triples (got {value!r})")
    out = []
    for pos, item in enumerate(value):
        try:
            agent, down, rejoin = item
            out.append((int(agent), int(down), int(rejoin)))
        except (TypeError, ValueError):
            raise SpecError(f"{where}[{pos}] is not an [agent, down_round, "
                            f"rejoin_round] integer triple (got {item!r})") from None
    return tuple(out)


def spec_from_dict(d: Dict[str, Any]) -> ExperimentSpec:
    """Load the JAX package's spec JSON layout (strict on unknown keys)."""
    top_unknown = sorted(set(d) - {"data", "agent", "solver", "backend",
                                   "transport", "faults", "obs", "seed"})
    if top_unknown:
        raise SpecError(f"unrecognised section(s) in spec dict: {top_unknown}")
    data = _checked_fields(DataSpec, d.get("data", {}), "spec['data']")
    for key in ("source_options", "partition_options"):
        data[key] = _pairs(data.get(key, ()), f"spec['data'][{key!r}]")
    agent = _checked_fields(AgentSpec, d.get("agent", {}), "spec['agent']")
    agent["options"] = _pairs(agent.get("options", ()), "spec['agent']['options']")
    trans = _checked_fields(TransportSpec, d.get("transport", {}),
                            "spec['transport']")
    for key in ("topology_options", "codec_options"):
        trans[key] = _pairs(trans.get(key, ()), f"spec['transport'][{key!r}]")
    faults = _checked_fields(FaultSpec, d.get("faults", {}), "spec['faults']")
    faults["crash"] = _crash_entries(faults.get("crash", ()),
                                     "spec['faults']['crash']")
    obs = _checked_fields(ObsSpec, d.get("obs", {}), "spec['obs']")
    obs["taps"] = tuple(str(t) for t in obs.get("taps", ()))
    return ExperimentSpec(
        data=DataSpec(**data),
        agent=AgentSpec(**agent),
        solver=SolverSpec(**_checked_fields(SolverSpec, d.get("solver", {}),
                                            "spec['solver']")),
        backend=BackendSpec(**_checked_fields(BackendSpec, d.get("backend", {}),
                                              "spec['backend']")),
        transport=TransportSpec(**trans),
        faults=FaultSpec(**faults),
        obs=ObsSpec(**obs),
        seed=d.get("seed", 0),
    )


def stream_spec_to_dict(spec: StreamSpec) -> Dict[str, Any]:
    d = dataclasses.asdict(spec)
    d["experiment"] = spec_to_dict(spec.experiment)
    return d


def stream_spec_from_dict(d: Dict[str, Any]) -> StreamSpec:
    """Load the JAX package's stream spec layout (strict on unknown keys)."""
    fields = _checked_fields(StreamSpec, d, "stream spec")
    fields["experiment"] = spec_from_dict(fields.get("experiment", {}))
    if "serve_buckets" in fields:
        fields["serve_buckets"] = tuple(int(b) for b in fields["serve_buckets"])
    return StreamSpec(**fields)
