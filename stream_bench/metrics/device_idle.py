"""device_idle (%), layer device: the share of the traced window in which
no kernel or copy ran on the card (one minus the union of the device
operations' intervals over the window's length); nothing where no
operation ran on a device."""


def read(run):
    tr = run.device_trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
