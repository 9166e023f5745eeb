"""Device (H100): the share of the traced part of the window in which no
kernel, copy or set ran on the card (``torch.profiler``), in probe cells."""


def read(obs):
    p = obs.profile
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
