"""The card's idle share of the traced window inside the program's chat
turns (session.turn spans: ChatSession.turn and continue_turn), in %; the
rest of idle_share.decode is the caller's time between turns."""

from harness.program_spans import idle_under


def read(r):
    return idle_under(r, "session.turn")
