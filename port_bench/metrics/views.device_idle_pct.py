"""The traced window of views' time with no operation on the device."""


def read(rec):
    if rec is None or rec["kind"] != "views":
        return None
    return 100.0 * (1.0 - rec["summary"].busy_s / rec["window_s"])
