"""The share of a step or build in which no operation ran on the card:
1 - (device-busy seconds an item, from the trace) / (seconds an item,
untraced)."""


def read(r):
    return 100 * (1 - r.busy_per_item_s() / r.per_item_s())
