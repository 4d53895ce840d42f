"""The whole step's share of the card's fp32 peak, in %, in the cells of
the plain nested step: ``step_mfu.py``'s reading, loaded from that file
by path so that both cells' readings are one computation."""

from pathlib import Path

from portbench.harness import load_module


def read(rec):
    return load_module(Path(__file__).with_name("step_mfu.py")).read(rec)
