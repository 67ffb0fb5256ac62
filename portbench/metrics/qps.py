"""``qps``: queries answered over the whole window, by the host clock."""


def read(rec):
    return rec.queries / rec.window_s if rec.window_s > 0 and rec.queries else None
