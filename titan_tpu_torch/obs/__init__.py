"""Observability plane of the port (the port's copy of ``titan_tpu/obs``):

* ``tracing``   — explicit start/end spans with parent links, an
  injectable clock and a bounded journal per trace; host bookkeeping fed
  by the round-boundary callbacks the models already make.
* ``flightrec`` — the bounded flight-recorder ring and its postmortem
  bundles.
* ``slo``       — declarative per-tenant / per-kind objectives evaluated
  from the labeled metric children into error-budget burn rates.
* ``devprof``   — device cost: kernel builds, per-kernel device time
  from CUDA events, H2D/D2H bytes.
* ``promexport`` — the registry as Prometheus text exposition 0.0.4,
  served by ``GET /metrics``; ``federate`` merges peers' expositions
  under ``instance`` labels (``GET /metrics?federate=1``, ``/fleet``).
"""

from titan_tpu_torch.obs.promexport import (CONTENT_TYPE,  # noqa: F401
                                            render_prometheus)
from titan_tpu_torch.obs.slo import SLO, SLOEngine  # noqa: F401
from titan_tpu_torch.obs.tracing import (NULL_SPAN, Span,  # noqa: F401
                                         TraceHandle, Tracer,
                                         trace_summary)
