"""Runtime telemetry (counterpart of ``hetu_tpu/obs``): the process-wide
metrics registry, the event journal, tracing spans (``obs.tracing``),
tensor fingerprints, group statistics, the flight recorder and NaN
provenance (``obs.numerics``), cross-replica divergence
(``obs.divergence``), goodput buckets and MFU (``obs.goodput``), the
fleet plane (``obs.fleet``), request timelines (``obs.reqtrace``), SLO
grading and burn rates (``obs.slo``), capture counts, ``watch`` and the
compile-storm detector (``obs.compile``), the HBM ledger
(``obs.memledger``), the calibration plane (``obs.calibration``) and
the scrape endpoint's route table (``obs.server``).  The package exports
what the reference's ``hetu_tpu.obs`` exports but ``InstrumentedJit`` and
``instrument``, which wrap ``jax.jit`` (``watch`` takes their place)."""

from hetu_tpu_torch.obs import (calibration, compile, divergence, fleet,
                                goodput, journal, memledger, numerics,
                                registry, reqtrace, server, slo, tracing)
from hetu_tpu_torch.obs.calibration import (Calibration, CalibrationKey,
                                            FittedConstant, ProfileStore,
                                            RegressionSentinel,
                                            fit_calibration, get_store,
                                            install_store)
from hetu_tpu_torch.obs.compile import (CaptureSite, StormDetector,
                                        compile_report, watch)
from hetu_tpu_torch.obs.memledger import (MemoryLedger, get_ledger,
                                          install_ledger)
from hetu_tpu_torch.obs.divergence import (DivergenceDetector,
                                           FingerprintBoard, compare_fleet)
from hetu_tpu_torch.obs.fleet import (FleetAggregator, SnapshotPublisher,
                                      fleet_routes, serve_fleet)
from hetu_tpu_torch.obs.goodput import GoodputMeter
from hetu_tpu_torch.obs.numerics import (FlightRecorder, first_nonfinite,
                                         install_recorder, loss_provenance)
from hetu_tpu_torch.obs.journal import (EventJournal, get_journal, record,
                                        set_journal, use)
from hetu_tpu_torch.obs.numerics import (fingerprint, group_stats,
                                         host_fingerprint,
                                         host_fingerprint_ints,
                                         host_group_stats, tree_fingerprints)
from hetu_tpu_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge,
                                         Histogram, MetricsRegistry, disable,
                                         enable, enabled, get_registry)
from hetu_tpu_torch.obs.reqtrace import ReqTraceBuffer, RequestTimeline
from hetu_tpu_torch.obs.server import (RoutedHTTPServer, Routes,
                                       TelemetryServer, serve,
                                       telemetry_routes)
from hetu_tpu_torch.obs.slo import SLOEngine, SLOTargets
from hetu_tpu_torch.obs.tracing import (Span, Tracer, current_span,
                                        get_tracer, span)

__all__ = ["registry", "journal", "tracing", "numerics", "reqtrace", "slo",
           "compile", "server", "divergence", "fleet", "goodput",
           "memledger", "calibration",
           "ProfileStore", "CalibrationKey", "Calibration", "FittedConstant",
           "RegressionSentinel", "fit_calibration", "install_store",
           "get_store", "CaptureSite", "StormDetector", "watch",
           "compile_report", "MemoryLedger", "install_ledger",
           "get_ledger",
           "enabled", "enable", "disable", "get_registry",
           "DivergenceDetector", "FingerprintBoard", "compare_fleet",
           "FleetAggregator", "SnapshotPublisher", "fleet_routes",
           "serve_fleet", "GoodputMeter", "FlightRecorder",
           "first_nonfinite", "install_recorder", "loss_provenance",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_BUCKETS", "Tracer", "Span", "get_tracer", "span",
           "current_span", "EventJournal", "get_journal", "set_journal",
           "use", "record", "TelemetryServer", "serve", "Routes",
           "RoutedHTTPServer", "telemetry_routes", "RequestTimeline",
           "ReqTraceBuffer", "SLOEngine", "SLOTargets", "fingerprint",
           "group_stats", "tree_fingerprints", "host_fingerprint",
           "host_fingerprint_ints", "host_group_stats"]
