"""Share of the attributed sub-window's device time taken by the kernels
that the eigenvalue group (``estimators.eigenvalues_core``: the Gram
product and the eigen solve) launched."""

FUNCTIONS = (("barc4dip_tpu_torch/metrics/estimators.py", "eigenvalues_core"),)


def read(record):
    tr = record["attributed"]
    own = None if tr is None else tr.attributed_device_s(FUNCTIONS)
    if own is None or tr.device_s <= 0:
        record["log"]("eig_device_pct: no eigenvalues_core event, or no device time, in the attributed sub-window")
        return None
    return 100.0 * own / tr.device_s
