"""The share of the sliding window's forwarded tile slots that hold a tile
the volume needs, from the port's counters over the whole run: ``sw.tiles``
over ``sw.tile_slots`` (a padded last chunk forwards zero tiles)."""

from portbench import spans


def read(record):
    c = spans.program_counters()
    if not c.get("sw.tile_slots"):
        return None
    return 100.0 * c.get("sw.tiles", 0) / c["sw.tile_slots"]
