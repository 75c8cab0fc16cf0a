"""The program's span records (``accel_tpu_torch/utils/profiler.py``), for
the readers that need each span's parent and not only the totals by name
(``spans.program_span_totals``)."""


def program_span_records():
    """The program's ``span_records()``, or None where it has none."""
    try:
        from accel_tpu_torch.utils.profiler import span_records
    except ImportError:
        return None
    return span_records()
