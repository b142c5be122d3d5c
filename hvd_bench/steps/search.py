"""Step kind ``search``: a user's ``--clear-search-cache`` re-run of a
scene library (``hvdb.cells.SceneCell``)."""

from hvdb.cells import SceneCell as Cell

__all__ = ["Cell"]
