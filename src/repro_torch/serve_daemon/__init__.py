"""Plan-cache serving daemon (``python -m repro_torch serve``): the port's
copy of ``repro.serve_daemon``.

MAGE's central artifact, the memory program, is a deterministic,
spec-hash-stamped function of the job spec (§5-§7), so a production
service should never trace or plan a repeated job shape again.  This
package is the serving layer built on that observation:

  cache.py      on-disk :class:`ArtifactCache` of traced bytecode,
                next-use sidecars, memory-program plans, batch and
                overlap schedules and aggregation round plans, keyed by
                spec hash, validated on hit like ``Session.from_plan``
                (tampered entries are rejected and made again), LRU
                size-capped; the JAX package's layout and format;
  admission.py  :class:`AdmissionController`: a shared frame pool plus
                planner and engine memory estimates bound how many
                tenants plan and execute at once;
  server.py     :class:`ServeDaemon`: a line-delimited JSON request
                protocol over a local (unix or TCP) socket; every job
                runs on the daemon's device, the card unless it was made
                with ``device="cpu"``;
  client.py     :class:`ServeClient` / :func:`serve_client`: what
                ``python -m repro_torch submit`` uses.
"""

from .admission import AdmissionController, AdmissionError
from .cache import ArtifactCache, CacheEntryError, CacheStats
from .client import ServeClient, ServeError, serve_client
from .server import ServeDaemon, program_digest

__all__ = ["AdmissionController", "AdmissionError", "ArtifactCache",
           "CacheEntryError", "CacheStats", "ServeClient", "ServeDaemon",
           "ServeError", "program_digest", "serve_client"]
