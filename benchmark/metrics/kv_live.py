"""The live share of the cache positions decode attention reads, in %, as
the program states it on its spans (batcher.step in serving, session.turn
in chat, summed over each turn's steps): the positions the traced
window's steps attend over (each live slot's position + 1, less its left
pad) over those the program says its attention reads (today every slot
of the cache: BatchEngine.positions, ChatSession._turn_attrs). A count of
the program's, not a measurement: an attention that reads fewer positions
moves it only where it updates those lines. In chat a traced window holds
the start of a conversation only."""

from harness.program_spans import logged


def read(r):
    spans = logged(r, ("batcher.step", "session.turn"))
    read_pos = sum(s.attrs.get("read_positions", 0) for s in spans)
    if not read_pos:
        return None
    live = sum(s.attrs.get("live_positions", 0) for s in spans)
    return 100.0 * live / read_pos
