"""Event source (``EvtDecoder``'s chunk decode, ``FileEventsIterator``'s
packet cuts): µs of the window's ``io.decode`` and ``io.packetize`` spans
over the window's ``pipe.packet`` spans."""

from benchmark.metrics import _records


def read(run):
    tree = _records.load(run)
    if tree is None:
        return None
    packets = len(tree.in_window("pipe.packet"))
    source = tree.total("io.decode") + tree.total("io.packetize")
    return source / packets * 1e6 if packets and source > 0 else None
