"""``slot_occupancy.batch``: the decode batcher's active slots over its
slot capacity, summed over the window's decode dispatches
(``decode_metrics`` ``slot_steps / slot_capacity_steps``), in %."""


def read(m):
    c = m.get("counters")
    if not c or not c.get("slot_capacity_steps"):
        return None
    return 100.0 * c["slot_steps"] / c["slot_capacity_steps"]
