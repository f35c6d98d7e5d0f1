"""Device time per window of the matcher's kernels (the conv, its layout
transposes, the chain, the finals and the DFA scans, by ``part_of``): their
device seconds per traced second, over the windows collected per second in
the part of the window before the slice. Both are rates, so a slice that a
graph capture cut short still reads the same quantity."""


def read(run):
    prof = run.profile
    if prof is None or not prof["parts"] or prof["window_s"] <= 0 or not run.windows:
        return None
    windows_per_s = len(run.windows) / run.seconds
    return sum(prof["parts"].values()) / prof["window_s"] / windows_per_s * 1e3
