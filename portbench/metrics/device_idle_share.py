"""Share of the traced slice in which no kernel ran on the card: 1 - (union
of kernel intervals / the slice's wall time)."""


def read(run):
    prof = run.profile
    if prof is None or prof["window_s"] <= 0 or not prof["n_kernels"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
