"""build_sym_s (Msym/s): the symbols of every build completed in the window
over the window's wall time, from the first build's start to the last
one's return: all the work over all the time."""


def read(run):
    if not run.builds or run.window_s <= 0:
        return None
    return len(run.builds) * run.cell.n / run.window_s / 1e6
