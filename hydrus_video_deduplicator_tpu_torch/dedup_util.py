"""Small shared utilities (reference: src/hydrusvideodeduplicator/dedup_util.py)."""

from __future__ import annotations

import logging
from itertools import islice
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from collections.abc import Generator, Iterable
    from typing import Any

    from .client.hydrus_api import Client

    Severity = int

try:
    from rich import print as _rich_print
except ImportError:  # pragma: no cover
    _rich_print = print


def batched(iterable: "Iterable", batch_size: int) -> "Generator[tuple, Any, None]":
    """Batch into tuples of batch_size; last batch may be shorter."""
    assert batch_size >= 1
    it = iter(iterable)
    while batch := tuple(islice(it, batch_size)):
        yield batch


def find_tag_in_tags(target_tag_namespace: str, tags: list) -> str:
    """Find a tag by namespace prefix in a sorted tag list; '' if absent."""
    n = len(target_tag_namespace)
    for tag in tags:
        if tag[:n] == target_tag_namespace:
            return tag[n:]
    return ""


def get_file_names_hydrus(client: "Client", file_hashes: list[str]) -> list[str]:
    """Best-effort 'filename:' tag lookup for debugging output."""
    result = []
    metadata = client.get_file_metadata(hashes=file_hashes, only_return_basic_information=False)
    all_known_tags = "all known tags".encode("utf-8").hex()
    for entry in metadata.get("metadata", []):
        ext = entry.get("ext", "")
        name = ""
        try:
            tags = entry["tags"][all_known_tags]["storage_tags"]["0"]
            name = find_tag_in_tags("filename:", tags)
            if name:
                name = f"{name}{ext}"
        except Exception as exc:
            logging.error(exc)
            logging.error("Cannot get file name from Hydrus. Hash: %s", entry.get("hash"))
        result.append(name)
    return result


def get_file_import_time(file_metadata: dict):
    """Import time into 'all local files' from a file_metadata record."""
    for service in file_metadata["file_services"]["current"].values():
        if service.get("name") == "all local files" and "time_imported" in service:
            return service["time_imported"]
    raise KeyError


def get_oldest_imported_file_time(all_files_metadata: list) -> int:
    times = []
    for metadata in all_files_metadata:
        try:
            times.append(get_file_import_time(metadata))
        except KeyError:
            continue
    return min(times)


def severity_to_color(severity: "Severity") -> str:
    if severity > logging.WARNING:
        return "[red]"
    if severity == logging.WARNING:
        return "[yellow]"
    return ""


def print_and_log(logger: logging.Logger, msg: str, severity: "Severity" = logging.INFO) -> None:
    """User-facing colored print + log record."""
    color = severity_to_color(severity)
    _rich_print(f"{color}{msg}" if color else msg)
    logger.log(severity, msg)
