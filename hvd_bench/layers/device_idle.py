"""device_idle.<cell>: the share of the traced window in which no kernel, copy
or memset ran on the device, in percent (torch.profiler)."""


def read(rec):
    return rec.idle_percent()
