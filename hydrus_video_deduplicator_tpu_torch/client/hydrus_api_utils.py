"""Helpers around the Hydrus Client API library — same function surface as
the reference's ``hydrus_api.utils`` module (scripts import it as
``hydrusvideodeduplicator.hydrus_api.utils``; the alias package registers
this module under that name)."""

from __future__ import annotations

from collections import defaultdict
from typing import TYPE_CHECKING, Any

from .hydrus_api import (
    DEFAULT_API_URL,
    HYDRUS_METADATA_ENCODING,
    Client,
    ImportStatus,
)

if TYPE_CHECKING:
    import os
    from collections.abc import Generator, Iterable, Sequence

__all__ = [
    "add_and_tag_files",
    "cli_request_api_key",
    "get_page_list",
    "get_service_mapping",
    "parse_hydrus_metadata",
    "parse_hydrus_metadata_file",
    "verify_permissions",
    "yield_chunks",
]


def verify_permissions(
    client: Client, permissions: "Iterable[int]", exact: bool = False
) -> bool:
    """True when the key's granted permissions cover (or exactly equal)
    ``permissions``."""
    granted = set(client.verify_access_key()["basic_permissions"])
    wanted = {int(p) for p in permissions}
    return granted == wanted if exact else granted.issuperset(wanted)


def cli_request_api_key(
    name: str,
    permissions: "Iterable[int]",
    verify: bool = True,
    exact: bool = False,
    api_url: str = DEFAULT_API_URL,
) -> str:
    """Interactively walk the user through granting an API key in the
    Hydrus client, retrying until the granted permissions satisfy the
    request."""
    permissions = list(permissions)
    while True:
        input(
            'Navigate to "services->review services->local->client api" in the'
            ' Hydrus client and click "add->from api request". Then press enter'
            " to continue..."
        )
        access_key = Client(api_url=api_url).request_new_permissions(name, permissions)[
            "access_key"
        ]
        input(
            "Press OK and then apply in the Hydrus client dialog. Then press"
            " enter to continue..."
        )
        client = Client(access_key, api_url)
        if verify and not verify_permissions(client, permissions, exact):
            granted = client.verify_access_key()["basic_permissions"]
            print(
                f"The granted permissions ({granted}) differ from the requested"
                f" permissions ({permissions}), please grant all requested"
                " permissions."
            )
            continue
        return access_key


def parse_hydrus_metadata(text: str) -> dict[str | None, set[str]]:
    """Parse Hydrus sidecar-style tag text into {namespace: tags} (the
    namespace of an unnamespaced tag is None)."""
    namespaces: dict[str | None, set[str]] = defaultdict(set)
    for line in (line.strip() for line in text.splitlines()):
        if not line:
            continue
        namespace, sep, tag = line.partition(":")
        if sep:
            namespaces[namespace].add(tag)
        else:
            namespaces[None].add(line)
    return dict(namespaces)


def parse_hydrus_metadata_file(path_or_file) -> dict[str | None, set[str]]:
    if hasattr(path_or_file, "read"):
        return parse_hydrus_metadata(path_or_file.read())
    with open(path_or_file, encoding=HYDRUS_METADATA_ENCODING) as fh:
        return parse_hydrus_metadata(fh.read())


def yield_chunks(
    sequence: "Sequence", chunk_size: int, offset: int = 0
) -> "Generator[Sequence, None, None]":
    """Slices of ``sequence`` of at most ``chunk_size`` (for splitting up
    get_file_metadata requests)."""
    while offset < len(sequence):
        yield sequence[offset : offset + chunk_size]
        offset += chunk_size


def add_and_tag_files(
    client: Client,
    paths_or_files: "Iterable",
    tags: "Iterable[str]",
    tag_service_keys: "Iterable[str]",
) -> list[dict[str, Any]]:
    """Import several files and tag every successful import; returns the
    add_file results in input order."""
    tags = list(tags)
    results = []
    hashes = set()
    for item in paths_or_files:
        if hasattr(item, "read"):
            item = item.read()
        result = client.add_file(item)
        results.append(result)
        if result["status"] != ImportStatus.FAILED:
            hashes.add(result["hash"])
    if hashes:
        client.add_tags(
            hashes=sorted(hashes),
            service_keys_to_tags={key: tags for key in tag_service_keys},
        )
    return results


def get_page_list(client: Client) -> list[dict[str, Any]]:
    """The page tree from get_pages() flattened in pre-order."""
    pages: list[dict[str, Any]] = []

    def walk(page: dict[str, Any]) -> None:
        pages.append(page)
        for sub in page.get("pages", ()):
            walk(sub)

    walk(client.get_pages()["pages"])
    return pages


def get_service_mapping(client: Client) -> dict[str, list[str]]:
    """{service name: [service keys]} over every service list the client
    reports."""
    mapping: dict[str, list[str]] = defaultdict(list)
    for services in client.get_services().values():
        # legacy response shape: type-named keys -> lists of services (the
        # modern flat "services" object is a dict and is skipped, matching
        # the reference helper's behavior)
        if isinstance(services, list):
            for service in services:
                mapping[service["name"]].append(service["service_key"])
    return dict(mapping)
