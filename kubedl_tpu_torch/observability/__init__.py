"""The serving engine's and the parameter service's metrics, and request
tracing: the port's copies of ``kubedl_tpu/observability/{metrics,tracing}.py``."""

from kubedl_tpu_torch.observability.metrics import (  # noqa: F401
    DEFAULT_PS_METRICS, MetricsRegistry, PSMetrics, ServingMetrics,
)
