"""What the per-build readers share: a quantity's mean over the window's
builds (its total over them, divided by their number)."""


def mean(run, get):
    if not run.builds:
        return None
    return sum(get(b) for b in run.builds) / len(run.builds)
