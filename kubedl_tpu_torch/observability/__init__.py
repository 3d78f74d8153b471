"""The serving engine's metrics and request tracing: the port's copies of
``kubedl_tpu/observability/{metrics,tracing}.py``."""

from kubedl_tpu_torch.observability.metrics import (  # noqa: F401
    MetricsRegistry, ServingMetrics,
)
