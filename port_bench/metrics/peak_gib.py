"""The most device memory the program allocated while answering one
request, above what the harness held when it handed the request over
(``max_memory_allocated`` after ``reset_peak_memory_stats``), the highest
over the window, GiB."""


def read(run):
    peaks = [r["peak_bytes"] for r in run.records]
    return max(peaks) / 2**30 if peaks and max(peaks) > 0 else None
