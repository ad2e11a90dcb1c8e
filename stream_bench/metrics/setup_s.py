"""setup_s (s): process start to the window's start, on the host clock:
imports, kernels built or loaded, raw streams made, preprocessed and
stored, one warm job."""


def read(run):
    return run.setup_s
