"""Step kind ``delta``: a returning user's run once stage 1 has queued new
videos on the searched scene library (``hvdb.cells.SceneCell``)."""

from hvdb.cells import SceneCell as Cell

__all__ = ["Cell"]
