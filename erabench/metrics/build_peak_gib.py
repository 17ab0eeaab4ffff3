"""build_peak_gib (GiB): the largest ``torch.cuda.max_memory_allocated()``
of any build in the window, the peak counter reset before each build."""


def read(run):
    peaks = [b.peak_bytes for b in run.builds]
    if not peaks or max(peaks) <= 0:
        return None
    return max(peaks) / 2**30
