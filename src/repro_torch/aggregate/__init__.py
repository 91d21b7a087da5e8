"""Many-client secure aggregation over the transport fabric (the port's
copy of ``repro.aggregate``).

Input-only clients (thousands, multiplexed over a few gateway
endpoints) stream additive shares to a small compute fleet, whose share
matrices and sums live on the card; the per-round schedule is derived
offline and cached (``serve_daemon.ArtifactCache``'s ``agg`` kind).
``python -m repro_torch agg`` is the CLI.
"""

from .offline import (AggSpec, RoundPlan, build_round_plan, client_shares,
                      client_vector, expected_sum, load_round_plan)
from .run import AggResult, largest_message, run_aggregation, \
    verify_aggregates

__all__ = [
    "AggSpec", "RoundPlan", "AggResult", "build_round_plan",
    "load_round_plan", "client_vector", "client_shares", "expected_sum",
    "largest_message", "run_aggregation", "verify_aggregates",
]
