"""``index_build_s``: the host clock around the program's index constructor and
``to_device``, ending in a device synchronize."""


def read(rec):
    return rec.index_build_s
