"""Beyond-paper simulation scenarios — scale sweeps for the cohort engine
and arch-task scenarios for the unified substrate.

The paper evaluates at 10 clients; Fraboni et al. and FedBuff-style designs
evaluate at hundreds. These scenarios keep the paper's task models but grow
the client population, pairing the vectorized cohort engine (DESIGN.md §7)
with the flat-state pallas server runtime and burst-window draining so a
round is a handful of device dispatches instead of hundreds.

Arch scenarios (:class:`ArchScenarioConfig`) are declarative — name, arch
id, reduction knobs, FedConfig — and resolve to a
``repro.core.tasks.ArchTask`` via ``tasks.as_task``, so the config layer
stays free of core/model imports while ``FederatedSimulation(SCENARIOS
["arch-danube-smoke"], ...)`` just works (DESIGN.md §10).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_tasks import (FEMNIST, SYNTHETIC_1_1,
                                       PaperTaskConfig)
from repro_torch.utils.registry import Registry

SCENARIOS: Registry = Registry("simulation scenario")


def _scaled(base: PaperTaskConfig, name: str, num_clients: int,
            samples_per_client: int, **fed_changes) -> PaperTaskConfig:
    fed = dataclasses.replace(base.fed, num_clients=num_clients,
                              client_engine="cohort", **fed_changes)
    return dataclasses.replace(base, name=name, num_clients=num_clients,
                               samples_per_client=samples_per_client,
                               fed=fed)


#: 256-client Synthetic-1-1: the large-scale cohort scenario. Every fan-out
#: site (seeding, burst re-dispatch) trains 256 clients in one dispatch;
#: the server drains arrival bursts through the batched fedagg kernels.
SYNTHETIC_256 = _scaled(SYNTHETIC_1_1, "synthetic-256", num_clients=256,
                        samples_per_client=64, backend="pallas",
                        batch_window=0.05, gmis_depth=256)

#: 64-client FEMNIST: mid-scale CNN scenario (pytree server, cohort clients).
FEMNIST_64 = _scaled(FEMNIST, "femnist-64", num_clients=64,
                     samples_per_client=128, gmis_depth=128)

# --- arrival-dynamics scenarios (client-behavior models, DESIGN.md §9) ---

#: Bursty arrivals + autotuned drain window: clients cluster on a global
#: Poisson burst process and the server opens its window from observed
#: inter-arrival density, draining each cluster through ONE multi-delta
#: kernel sweep. The scenario behind the auto-vs-fixed bench row
#: (benchmarks/arrival_bench.py).
SYNTHETIC_BURST = _scaled(
    SYNTHETIC_1_1, "synthetic-burst", num_clients=32, samples_per_client=64,
    backend="pallas", batch_window="auto", gmis_depth=128,
    client_behavior="poisson-burst",
    behavior_params=(("burst_gap", 0.6), ("jitter", 0.01)))

#: Time-of-day load swings with client churn: device throughput follows a
#: sinusoidal diurnal profile and 2% of rounds end in a temporary offline
#: gap — arrival density drifts, exercising the auto controller's
#: open/close transitions.
SYNTHETIC_DIURNAL = _scaled(
    SYNTHETIC_1_1, "synthetic-diurnal", num_clients=32,
    samples_per_client=64, batch_window="auto",
    client_behavior="diurnal", churn_prob=0.02,
    behavior_params=(("period", 15.0), ("amplitude", 0.7)))

#: Replayed round-duration traces: every client cycles a deterministic
#: lognormal trace synthesized from the seed — the template for driving
#: the simulator from recorded production inter-arrival logs.
SYNTHETIC_TRACE = _scaled(
    SYNTHETIC_1_1, "synthetic-trace", num_clients=16, samples_per_client=64,
    client_behavior="trace")

#: ONE MILLION clients under the population engine (DESIGN.md §12): a
#: diurnal check-in process at ~40 arrivals per unit virtual time over a
#: 1M-strong population, lazily materialized on first contact. Per-drain
#: cost scales with the arrival rate — the wall-clock is flat in
#: population size (benchmarks/arrival_bench.py --populations pins
#: 1M <= 1.5x of 10k). Sessions are one-shot (stay_prob 0.3 keeps a
#: minority training back-to-back rounds), and auto-window draining
#: batches the diurnal peaks through the multi-delta kernel.
SYNTHETIC_1M = _scaled(
    SYNTHETIC_1_1, "synthetic-1m", num_clients=1_000_000,
    samples_per_client=64, backend="pallas", batch_window="auto",
    gmis_depth=256, client_behavior="diurnal",
    population="table", arrival_rate=40.0, session_stay_prob=0.3,
    behavior_params=(("period", 20.0), ("amplitude", 0.8)))

#: THE baseline FedConfig for arch tasks — the old ``run_arch_federated``
#: loop's knobs (gentle lr/momentum for real transformers, small K) plus
#: the cohort engine and auto window. ``core.tasks.ArchTask.fed`` returns
#: this same object, so the scenario entries and ad-hoc ``arch_task(...)``
#: handles can never drift apart.
ARCH_FED_BASELINE = FedConfig(lam=1.0, eps=1.0, gamma_bar=2.0, kappa=1.0,
                              k_initial=2, num_clients=4, local_lr=3e-3,
                              local_momentum=0.9, local_lr_decay=1.0,
                              client_engine="cohort", batch_window="auto")


@dataclasses.dataclass(frozen=True)
class ArchScenarioConfig:
    """Declarative arch-task scenario (DESIGN.md §10): which assigned
    architecture, at what reduced scale, under which FedConfig.
    ``repro.core.tasks.as_task`` resolves it to an ``ArchTask``."""
    name: str
    arch_id: str
    seq_len: int = 64
    global_batch: int = 4
    num_layers: int = 2
    d_model: int = 256
    fed: FedConfig = ARCH_FED_BASELINE


#: Dense-attention arch through the full event runtime: cohort engine,
#: auto window, SimResult telemetry — the smoke entry point for the
#: large-arch path the old run_arch_federated loop bypassed.
ARCH_DANUBE_SMOKE = ArchScenarioConfig("arch-danube-smoke",
                                       "h2o-danube-1.8b")

#: SSM family (Mamba-2 SSD blocks) on the same runtime.
ARCH_MAMBA2_SMOKE = ArchScenarioConfig("arch-mamba2-smoke", "mamba2-1.3b")

#: Memory-budgeted cohort: an 8-client fan-out planned against a 64 MiB
#: per-dispatch budget — exercises the vmap-width clamp / K-microbatch /
#: loop fallback ladder (repro.core.budget) end-to-end.
ARCH_DANUBE_BUDGETED = ArchScenarioConfig(
    "arch-danube-budgeted", "h2o-danube-1.8b",
    fed=dataclasses.replace(ARCH_FED_BASELINE, num_clients=8,
                            memory_budget_mb=64))

for _s in (SYNTHETIC_256, FEMNIST_64, SYNTHETIC_BURST, SYNTHETIC_DIURNAL,
           SYNTHETIC_TRACE, SYNTHETIC_1M, ARCH_DANUBE_SMOKE,
           ARCH_MAMBA2_SMOKE, ARCH_DANUBE_BUDGETED):
    SCENARIOS.register(_s.name)(_s)
