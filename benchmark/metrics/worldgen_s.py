"""worldgen_s: host seconds of the world's generation, packing and upload in
set-up (``World.generate`` and ``to_torch``)."""


def read(record: dict, work: dict):
    return record.get("worldgen_s")
