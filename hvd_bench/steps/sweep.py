"""Step kind ``sweep``: one exact all-pairs sweep of a library held in
memory, through the engine a row chunk (``hvdb.cells.SweepCell``)."""

from hvdb.cells import SweepCell as Cell

__all__ = ["Cell"]
