"""Push failed files onto a named Hydrus FILE_SEARCH page.

Reference: upstream src/hydrusvideodeduplicator/page_logger.py.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

from .client.hydrus_api import PageType
from .dedup_util import print_and_log

if TYPE_CHECKING:
    from typing import Any

    from .client import HVDClient


def find_page_key_from_name(page: "dict[str, Any]", page_name: str) -> str | None:
    """Depth-first search of the get_pages tree for a FILE_SEARCH page with
    the given (case-insensitive) name."""
    if page["name"].lower() == page_name.lower() and page["page_type"] == int(
        PageType.FILE_SEARCH
    ):
        return page["page_key"]
    for subpage in page.get("pages", []):
        found = find_page_key_from_name(subpage, page_name)
        if found is not None:
            return found
    return None


def get_page_key(client: "HVDClient", page_name: str) -> str | None:
    response = client.client.get_pages()
    return find_page_key_from_name(response["pages"], page_name)


class HydrusPageLogger:
    """Adds files to a page in Hydrus (the page must already exist)."""

    _log = logging.getLogger("HydrusPageLogger")

    def __init__(self, client: "HVDClient", page_name: str):
        self.client = client
        self.page_name = page_name

    def add_failed_video(self, video_hash: str) -> None:
        try:
            page_key = get_page_key(self.client, self.page_name)
            if page_key is None:
                raise Exception("page_key is None.")
        except Exception as exc:
            print_and_log(self._log, str(exc), logging.ERROR)
            print_and_log(
                self._log,
                f"Error when trying to get page key for page name {self.page_name}",
                logging.ERROR,
            )
            return
        try:
            self.client.client.add_files_to_page(page_key=page_key, hashes=[video_hash])
        except Exception as exc:
            print_and_log(self._log, str(exc), logging.ERROR)
            print_and_log(
                self._log,
                f"Error adding file '{video_hash}' to page '{self.page_name}'"
                f" (page_key '{page_key}'). Ensure a page named"
                f" '{self.page_name}' exists in Hydrus.",
                logging.ERROR,
            )
