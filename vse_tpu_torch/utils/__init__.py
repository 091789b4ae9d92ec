from vse_tpu_torch.utils.metrics import StageTimer, Throughput
from vse_tpu_torch.utils.tracing import trace_context

__all__ = ["StageTimer", "Throughput", "trace_context"]
