from .scan import span_scan, span_scan_blocked

__all__ = ["span_scan", "span_scan_blocked"]
