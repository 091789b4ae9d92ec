from vse_tpu_torch.utils.tracing import annotate, count, record, trace_context

__all__ = ["annotate", "count", "record", "trace_context"]
