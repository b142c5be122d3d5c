"""Hydrus client wrapper: connection management, validation, and the
dedupe-specific API surface.

Reference: upstream src/hydrusvideodeduplicator/client.py (HVDClient,
create_client, exception mapping).
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING

from . import hydrus_api

if TYPE_CHECKING:
    from collections.abc import Iterable

    FileServiceKeys = list[str]
    FileHashes = Iterable[str]

log = logging.getLogger("HVDClient")


class ClientAPIException(Exception):
    """Base exception for HVDClient failures (carries a user-facing message)."""

    def __init__(self, pretty_msg: str = "", real_msg: str = ""):
        super().__init__(real_msg)
        self.pretty_msg = pretty_msg


class FailedHVDClientConnection(ClientAPIException):
    """Raised when the client cannot connect to Hydrus."""


class InsufficientPermissions(ClientAPIException):
    """Raised when the API key lacks required permissions."""


class HVDClient:
    _log = log

    def __init__(
        self,
        file_service_keys: "FileServiceKeys | None",
        api_url: str,
        access_key: str,
        verify_cert: str | None,  # None = do not verify TLS
    ):
        self.client = hydrus_api.Client(
            access_key=access_key, api_url=api_url, verify_cert=verify_cert
        )
        self.file_service_keys = (
            [key for key in file_service_keys if key.strip()]
            if file_service_keys
            else self.get_default_file_service_keys()
        )
        self.verify_file_service_keys()

    # -- services ---------------------------------------------------------

    def get_default_file_service_keys(self) -> "FileServiceKeys":
        services = self.client.get_services()
        # default to "all local files"
        return [services["all_local_files"][0]["service_key"]]

    def verify_file_service_keys(self) -> None:
        """Every configured key must name a local file service."""
        valid_types = (
            int(hydrus_api.ServiceType.ALL_LOCAL_FILES),
            int(hydrus_api.ServiceType.FILE_DOMAIN),
        )
        services = self.client.get_services()
        for key in self.file_service_keys:
            service = services["services"].get(key)
            if service is None:
                raise KeyError(f"Invalid file service key: '{key}'")
            if service.get("type") not in valid_types:
                raise KeyError("File service key must be a local file service")

    # -- versions / permissions -------------------------------------------

    def get_api_version(self) -> int:
        """Version of the API module used to talk to Hydrus."""
        return self.client.VERSION

    def get_hydrus_api_version(self):
        try:
            response = self.client.get_api_version()
        except hydrus_api.HydrusAPIException as exc:
            raise ClientAPIException(
                "Failed to fetch the Hydrus API version. Is Hydrus still running?",
                str(exc),
            )
        if "version" not in response:
            raise ClientAPIException(
                "'version' missing from the Hydrus API version response."
            )
        return response["version"]

    def verify_permissions(self) -> None:
        """Raise ClientAPIException unless the key has every permission."""
        try:
            ok = hydrus_api.verify_permissions(self.client, hydrus_api.Permission)
        except hydrus_api.HydrusAPIException as exc:
            raise ClientAPIException(
                "An error has occurred while trying to verify permissions.", str(exc)
            )
        if not ok:
            raise ClientAPIException("Insufficient Hydrus permissions.")

    # -- files ------------------------------------------------------------

    def get_video_hashes(self, search_tags: "Iterable[str]") -> "Iterable[str]":
        """SHA256 hashes of files matching the tags, smallest file first
        (FILE_SIZE ascending — reference client.py:118-132)."""
        return self.client.search_files(
            tags=search_tags,
            file_service_keys=self.file_service_keys,
            file_sort_type=hydrus_api.FileSortType.FILE_SIZE,
            file_sort_asc=True,
            return_hashes=True,
            return_file_ids=False,
        )["hashes"]

    def get_video(self, video_hash: str) -> bytes:
        """Download a file's bytes by SHA256 hash."""
        return self.client.get_file(hash_=video_hash).content

    def are_files_deleted_hydrus(self, file_hashes: "FileHashes") -> dict[str, bool]:
        """{hash: is_deleted} for the given files."""
        metadata = self.client.get_file_metadata(
            hashes=file_hashes, only_return_basic_information=False
        )["metadata"]
        result: dict[str, bool] = {}
        for entry in metadata:
            if "hash" not in entry:
                self._log.error("Hash not found for potentially trashed file.")
                continue
            result[entry["hash"]] = entry.get("is_deleted", False)
        return result

    # -- relationships ----------------------------------------------------

    def get_potential_duplicate_count_hydrus(self) -> int:
        return self.client.get_potentials_count(file_service_keys=self.file_service_keys)[
            "potential_duplicates_count"
        ]

    def reset_potential_duplicates(self, file_hashes: "Iterable[str]") -> None:
        self.client.remove_potentials(hashes=file_hashes)


def create_client(*args) -> HVDClient:
    """Create an HVDClient, mapping failures to user-friendly messages.

    Raises FailedHVDClientConnection on any failure.
    """
    try:
        return HVDClient(*args)
    except hydrus_api.InsufficientAccess as exc:
        pretty, real = "Invalid Hydrus API key.", str(exc)
    except hydrus_api.DatabaseLocked as exc:
        pretty, real = "Hydrus database is locked. Try again later.", str(exc)
    except hydrus_api.ServerError as exc:
        pretty, real = "Unknown Server Error.", str(exc)
    except hydrus_api.APIError as exc:
        pretty, real = "API Error", str(exc)
    except (hydrus_api.ConnectionError, hydrus_api.HydrusAPIException) as exc:
        real = str(exc)
        if "SSL" in real:
            pretty = "Failed to connect to Hydrus. SSL certificate verification failed."
        elif "Connection aborted" in real:
            pretty = (
                "Failed to connect to Hydrus.\nDoes your Hydrus Client API"
                " 'http/https' setting match your API URL?"
            )
        elif "Connection refused" in real:
            pretty = (
                "Failed to connect to Hydrus.\n"
                "Is your Hydrus instance running?\n"
                "Is the client API enabled?"
                " (hint: services -> manage services -> client api)\n"
                "Is your port correct? (hint: default is 45869)"
            )
        else:
            pretty = "Failed to connect to Hydrus. Unknown exception occurred."
    raise FailedHVDClientConnection(pretty, real)
