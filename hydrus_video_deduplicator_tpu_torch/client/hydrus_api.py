"""Hydrus Client API library (our own implementation).

Speaks the public Hydrus Client API (https://hydrusnetwork.github.io/hydrus/
client_api.html); the subset implemented covers everything the dedupe
pipeline uses (search, file download, relationships, pages, services,
permissions) — the same observable surface as the reference's vendored
client (SURVEY.md §2 row 10).

Conventions:
- access key via the ``Hydrus-Client-API-Access-Key`` header
- GET parameters that are lists/bools are JSON-encoded
- HTTP errors map to typed exceptions; 401/403/419 (session timeout) all
  raise InsufficientAccess, 503 DatabaseLocked, 500 ServerError,
  409 DeleteLocked, 400 MissingParameter
- ``verify_cert=None`` disables TLS verification (Hydrus uses a
  self-signed cert by default)
"""

from __future__ import annotations

import enum
import json
from typing import TYPE_CHECKING, Any

import requests

if TYPE_CHECKING:
    from collections.abc import Iterable, Mapping

DEFAULT_API_URL = "http://127.0.0.1:45869/"
HYDRUS_METADATA_ENCODING = "utf-8"
#: Hydrus returns this non-standard code when a session key expires.
AUTHENTICATION_TIMEOUT_CODE = 419


class HydrusAPIException(Exception):
    """Base class for all errors raised by this module."""


class ConnectionError(HydrusAPIException, requests.ConnectionError):
    """Network-level failure reaching the Hydrus client."""


class APIError(HydrusAPIException):
    def __init__(self, response: requests.Response):
        super().__init__(response.text)
        self.response = response


class MissingParameter(APIError):
    pass


class InsufficientAccess(APIError):
    pass


class DatabaseLocked(APIError):
    pass


class ServerError(APIError):
    pass


class DeleteLocked(APIError):
    pass


class _IntEnum(enum.IntEnum):
    def __str__(self) -> str:
        return str(self.value)


@enum.unique
class Permission(_IntEnum):
    IMPORT_URLS = 0
    IMPORT_FILES = 1
    ADD_TAGS = 2
    SEARCH_FILES = 3
    MANAGE_PAGES = 4
    MANAGE_COOKIES = 5
    MANAGE_DATABASE = 6
    ADD_NOTES = 7
    MANAGE_FILE_RELATIONSHIPS = 8
    EDIT_FILE_RATINGS = 9
    MANAGE_POPUPS = 10
    EDIT_TIMES = 11
    COMMIT_PENDING = 12


@enum.unique
class ServiceType(_IntEnum):
    TAG_REPOSITORY = 0
    FILE_REPOSITORY = 1
    FILE_DOMAIN = 2
    TAG_DOMAIN = 5
    NUMERICAL_RATING = 6
    LIKE_DISLIKE_RATING = 7
    ALL_KNOWN_TAGS = 10
    ALL_KNOWN_FILES = 11
    LOCAL_BOORU = 12
    IPFS = 13
    TRASH = 14
    ALL_LOCAL_FILES = 15
    FILE_NOTES = 17
    CLIENT_API = 18
    ALL_DELETED_FILES = 19
    LOCAL_UPDATES = 20
    ALL_MY_FILES = 21
    SERVER_ADMINISTRATION = 99


@enum.unique
class FileSortType(_IntEnum):
    FILE_SIZE = 0
    DURATION = 1
    IMPORT_TIME = 2
    FILE_TYPE = 3
    RANDOM = 4
    WIDTH = 5
    HEIGHT = 6
    RATIO = 7
    NUMBER_OF_PIXELS = 8
    NUMBER_OF_TAGS = 9
    NUMBER_OF_MEDIA_VIEWS = 10
    TOTAL_MEDIA_VIEWTIME = 11
    APPROXIMATE_BITRATE = 12
    HAS_AUDIO = 13
    MODIFIED_TIME = 14
    FRAMERATE = 15
    NUMBER_OF_FRAMES = 16
    LAST_VIEWED_TIME = 18
    ARCHIVE_TIMESTAMP = 19
    HASH_HEX = 20


@enum.unique
class DuplicateStatus(_IntEnum):
    POTENTIAL_DUPLICATES = 0
    FALSE_POSITIVES = 1
    ALTERNATES = 3
    DUPLICATES = 8


@enum.unique
class TagAction(_IntEnum):
    ADD = 0
    DELETE = 1
    PEND = 2
    RESCIND_PENDING = 3
    PETITION = 4
    RESCIND_PETITION = 5


class URLType(_IntEnum):
    POST_URL = 0
    FILE_URL = 2
    GALLERY_URL = 3
    WATCHABLE_URL = 4
    UNKNOWN_URL = 5


@enum.unique
class ImportStatus(_IntEnum):
    IMPORTABLE = 0
    SUCCESS = 1
    EXISTS = 2
    PREVIOUSLY_DELETED = 3
    FAILED = 4
    VETOED = 7


class PageType(_IntEnum):
    GALLERY_DOWNLOADER = 1
    SIMPLE_DOWNLOADER = 2
    HARD_DRIVE_IMPORT = 3
    PETITIONS = 5
    FILE_SEARCH = 6
    URL_DOWNLOADER = 7
    DUPLICATES = 8
    THREAD_WATCHER = 9
    PAGE_OF_PAGES = 10


@enum.unique
class TimestampType(_IntEnum):
    MODIFIED_DOMAIN = 0
    MODIFIED_FILE = 1
    MODIFIED_AGGREGATE = 2
    IMPORTED = 3
    DELETED = 4
    ARCHIVED = 5
    LAST_VIEWED = 6
    PREVIOUSLY_VIEWED = 7


@enum.unique
class CanvasType(_IntEnum):
    MEDIA_VIEWER = 0
    PREVIEW_VIEWER = 1


@enum.unique
class RenderFormat(_IntEnum):
    JPEG = 1
    PNG = 2
    WEBP = 33  # Hydrus's own constant for webp really is 33


def _files_payload(
    hashes: "Iterable[str] | None" = None,
    file_ids: "Iterable[int] | None" = None,
    require: bool = True,
    **extra: Any,
) -> dict[str, Any]:
    """Common {hashes|file_ids, ...} POST payload; coerces iterables and
    drops None-valued extras."""
    if require and hashes is None and file_ids is None:
        raise ValueError("At least one of hashes, file_ids is required")
    payload: dict[str, Any] = {}
    if hashes is not None:
        payload["hashes"] = list(hashes)
    if file_ids is not None:
        payload["file_ids"] = list(file_ids)
    for k, v in extra.items():
        if v is not None:
            payload[k] = v
    return payload


def _jdump(value: Any) -> str:
    """JSON-encode, coercing sets/tuples/generators and IntEnums."""

    def default(o):
        if isinstance(o, enum.IntEnum):
            return o.value
        try:
            return list(o)
        except TypeError:
            raise TypeError(f"not JSON-serializable: {o!r}")

    return json.dumps(value, default=default)


class Client:
    """Minimal Hydrus Client API client."""

    VERSION = 70  # newest Client API version this module targets

    def __init__(
        self,
        access_key: str | None = None,
        api_url: str = DEFAULT_API_URL,
        session: requests.Session | None = None,
        verify_cert: str | None = None,
    ):
        self.access_key = access_key
        self.api_url = api_url.rstrip("/")
        self.verify_cert = verify_cert
        self.session = session or requests.Session()

    # -- plumbing ---------------------------------------------------------

    def _request(self, method: str, path: str, **kwargs) -> requests.Response:
        headers = kwargs.setdefault("headers", {})
        if self.access_key is not None:
            headers["Hydrus-Client-API-Access-Key"] = self.access_key
        json_payload = kwargs.pop("json", None)
        if json_payload is not None:
            kwargs["data"] = _jdump(json_payload)
            headers["Content-Type"] = "application/json"
        if self.verify_cert is None:
            kwargs["verify"] = False
            try:
                requests.packages.urllib3.disable_warnings()
            except Exception:
                pass
        else:
            kwargs["verify"] = self.verify_cert

        try:
            response = self.session.request(method, self.api_url + path, **kwargs)
        except requests.RequestException as exc:
            raise ConnectionError(*exc.args)

        if response.status_code >= 400:
            code = response.status_code
            if code == 400:
                raise MissingParameter(response)
            if code in (401, 403, AUTHENTICATION_TIMEOUT_CODE):
                raise InsufficientAccess(response)
            if code == 503:
                raise DatabaseLocked(response)
            if code == 500:
                raise ServerError(response)
            if code == 409:
                raise DeleteLocked(response)
            raise APIError(response)
        return response

    # -- access management ------------------------------------------------

    def get_api_version(self) -> dict[str, Any]:
        return self._request("GET", "/api_version").json()

    def verify_access_key(self) -> dict[str, Any]:
        return self._request("GET", "/verify_access_key").json()

    def request_new_permissions(self, name: str, permissions: "Iterable[int]") -> dict[str, Any]:
        return self._request(
            "GET",
            "/request_new_permissions",
            params={"name": name, "basic_permissions": _jdump(permissions)},
        ).json()

    def get_services(self) -> dict[str, Any]:
        return self._request("GET", "/get_services").json()

    def get_service(
        self, service_name: str | None = None, service_key: str | None = None
    ) -> dict[str, Any]:
        if service_name is None and service_key is None:
            raise ValueError("At least one of service_name, service_key is required")
        params: dict[str, Any] = {}
        if service_name is not None:
            params["service_name"] = service_name
        elif service_key is not None:
            params["service_key"] = service_key
        return self._request("GET", "/get_service", params=params).json()

    # -- files -------------------------------------------------------------

    def search_files(
        self,
        tags: "Iterable[str]",
        file_service_keys: "Iterable[str] | None" = None,
        tag_service_key: str | None = None,
        file_sort_type: int | None = None,
        file_sort_asc: bool | None = None,
        return_file_ids: bool | None = None,
        return_hashes: bool | None = None,
    ) -> dict[str, Any]:
        params: dict[str, Any] = {"tags": _jdump(tags)}
        if file_service_keys is not None:
            params["file_service_keys"] = _jdump(file_service_keys)
        if tag_service_key is not None:
            params["tag_service_key"] = tag_service_key
        if file_sort_type is not None:
            params["file_sort_type"] = int(file_sort_type)
        if file_sort_asc is not None:
            params["file_sort_asc"] = _jdump(file_sort_asc)
        if return_file_ids is not None:
            params["return_file_ids"] = _jdump(return_file_ids)
        if return_hashes is not None:
            params["return_hashes"] = _jdump(return_hashes)
        return self._request("GET", "/get_files/search_files", params=params).json()

    def get_file(self, hash_: str | None = None, file_id: int | None = None) -> requests.Response:
        if (hash_ is None) == (file_id is None):
            raise ValueError("Exactly one of hash_, file_id is required")
        params: dict[str, Any] = {}
        if hash_ is not None:
            params["hash"] = hash_
        if file_id is not None:
            params["file_id"] = file_id
        return self._request("GET", "/get_files/file", params=params, stream=True)

    def get_thumbnail(
        self, hash_: str | None = None, file_id: int | None = None
    ) -> requests.Response:
        if (hash_ is None) == (file_id is None):
            raise ValueError("Exactly one of hash_, file_id is required")
        params: dict[str, Any] = {}
        if hash_ is not None:
            params["hash"] = hash_
        if file_id is not None:
            params["file_id"] = file_id
        return self._request("GET", "/get_files/thumbnail", params=params, stream=True)

    def get_render(
        self,
        hash_: str | None = None,
        file_id: int | None = None,
        download: bool | None = None,
        render_format: int | None = None,
        render_quality: int | None = None,
        width: int | None = None,
        height: int | None = None,
    ) -> requests.Response:
        """Render the file to an image format (e.g. a PSD to PNG)."""
        if (hash_ is None) == (file_id is None):
            raise ValueError("Exactly one of hash_, file_id is required")
        params: dict[str, Any] = {}
        if hash_ is not None:
            params["hash"] = hash_
        if file_id is not None:
            params["file_id"] = file_id
        if download is not None:
            params["download"] = _jdump(download)
        if render_format is not None:
            params["render_format"] = int(render_format)
        if render_quality is not None:
            params["render_quality"] = render_quality
        if width is not None:
            params["width"] = width
        if height is not None:
            params["height"] = height
        return self._request("GET", "/get_files/render", params=params, stream=True)

    def get_file_hashes(
        self,
        hashes: "Iterable[str]",
        desired_hash_type: str,
        source_hash_type: str | None = None,
    ) -> dict[str, Any]:
        """Translate between hash types (sha256/md5/sha1/sha512)."""
        params: dict[str, Any] = {
            "hashes": _jdump(hashes),
            "desired_hash_type": desired_hash_type,
        }
        if source_hash_type is not None:
            params["source_hash_type"] = source_hash_type
        return self._request("GET", "/get_files/file_hashes", params=params).json()

    def get_file_metadata(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
        only_return_basic_information: bool | None = None,
    ) -> dict[str, Any]:
        if hashes is None and file_ids is None:
            raise ValueError("At least one of hashes, file_ids is required")
        params: dict[str, Any] = {}
        if hashes is not None:
            params["hashes"] = _jdump(hashes)
        if file_ids is not None:
            params["file_ids"] = _jdump(file_ids)
        if only_return_basic_information is not None:
            params["only_return_basic_information"] = _jdump(only_return_basic_information)
        return self._request("GET", "/get_files/file_metadata", params=params).json()

    # -- relationships -----------------------------------------------------

    def set_file_relationships(self, relationships: "Iterable[Mapping[str, Any]]") -> None:
        self._request(
            "POST",
            "/manage_file_relationships/set_file_relationships",
            json={"relationships": list(relationships)},
        )

    @staticmethod
    def _dup_search_params(
        file_service_keys=None,
        deleted_file_service_keys=None,
        tag_service_key_1=None,
        tags_1=None,
        tag_service_key_2=None,
        tags_2=None,
        potentials_search_type=None,
        pixel_duplicates=None,
        max_hamming_distance=None,
    ) -> dict[str, Any]:
        """The duplicate-filter file-search parameter set shared by the
        potentials count/pairs/random endpoints."""
        params: dict[str, Any] = {}
        if file_service_keys is not None:
            params["file_service_keys"] = _jdump(file_service_keys)
        if deleted_file_service_keys is not None:
            params["deleted_file_service_keys"] = _jdump(deleted_file_service_keys)
        if tag_service_key_1 is not None:
            params["tag_service_key_1"] = tag_service_key_1
        if tags_1 is not None:
            params["tags_1"] = _jdump(tags_1)
        if tag_service_key_2 is not None:
            params["tag_service_key_2"] = tag_service_key_2
        if tags_2 is not None:
            params["tags_2"] = _jdump(tags_2)
        if potentials_search_type is not None:
            params["potentials_search_type"] = int(potentials_search_type)
        if pixel_duplicates is not None:
            params["pixel_duplicates"] = int(pixel_duplicates)
        if max_hamming_distance is not None:
            params["max_hamming_distance"] = int(max_hamming_distance)
        return params

    def get_potentials_count(
        self, file_service_keys: "Iterable[str] | None" = None, **search
    ) -> dict[str, Any]:
        if file_service_keys is None:
            raise ValueError("file_service_keys is required")
        params = self._dup_search_params(file_service_keys, **search)
        return self._request(
            "GET", "/manage_file_relationships/get_potentials_count", params=params
        ).json()

    def get_potential_pairs(
        self,
        file_service_keys: "Iterable[str] | None" = None,
        deleted_file_service_keys: "Iterable[str] | None" = None,
        tag_service_key_1: str | None = None,
        tags_1: "Iterable[str] | None" = None,
        tag_service_key_2: str | None = None,
        tags_2: "Iterable[str] | None" = None,
        potentials_search_type: int | None = None,
        pixel_duplicates: int | None = None,
        max_hamming_distance: int | None = None,
        max_num_pairs: int | None = None,
    ) -> dict[str, Any]:
        params = self._dup_search_params(
            file_service_keys,
            deleted_file_service_keys,
            tag_service_key_1,
            tags_1,
            tag_service_key_2,
            tags_2,
            potentials_search_type,
            pixel_duplicates,
            max_hamming_distance,
        )
        if max_num_pairs is not None:
            params["max_num_pairs"] = int(max_num_pairs)
        return self._request(
            "GET", "/manage_file_relationships/get_potential_pairs", params=params
        ).json()

    def get_random_potentials(
        self,
        file_service_keys: "Iterable[str] | None" = None,
        deleted_file_service_keys: "Iterable[str] | None" = None,
        tag_service_key_1: str | None = None,
        tags_1: "Iterable[str] | None" = None,
        tag_service_key_2: str | None = None,
        tags_2: "Iterable[str] | None" = None,
        potentials_search_type: int | None = None,
        pixel_duplicates: int | None = None,
        max_hamming_distance: int | None = None,
    ) -> dict[str, Any]:
        if file_service_keys is None and deleted_file_service_keys is None:
            raise ValueError(
                "At least one of file_service_keys, deleted_file_service_keys is required"
            )
        params = self._dup_search_params(
            file_service_keys,
            deleted_file_service_keys,
            tag_service_key_1,
            tags_1,
            tag_service_key_2,
            tags_2,
            potentials_search_type,
            pixel_duplicates,
            max_hamming_distance,
        )
        return self._request(
            "GET", "/manage_file_relationships/get_random_potentials", params=params
        ).json()

    def remove_potentials(
        self, file_ids: "Iterable[int] | None" = None, hashes: "Iterable[str] | None" = None
    ) -> None:
        payload: dict[str, Any] = {}
        if file_ids is not None:
            payload["file_ids"] = list(file_ids)
        if hashes is not None:
            payload["hashes"] = list(hashes)
        self._request("POST", "/manage_file_relationships/remove_potentials", json=payload)

    # -- adding files --------------------------------------------------------

    def add_file(self, path_or_bytes: "str | bytes") -> dict[str, Any]:
        """Import a file: raw bytes, or a path the *client machine* can read."""
        if isinstance(path_or_bytes, (bytes, bytearray)):
            return self._request(
                "POST",
                "/add_files/add_file",
                data=bytes(path_or_bytes),
                headers={"Content-Type": "application/octet-stream"},
            ).json()
        return self._request(
            "POST", "/add_files/add_file", json={"path": str(path_or_bytes)}
        ).json()

    def delete_files(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
        file_service_keys: "Iterable[str] | None" = None,
        reason: str | None = None,
    ) -> None:
        payload: dict[str, Any] = {}
        if hashes is not None:
            payload["hashes"] = list(hashes)
        if file_ids is not None:
            payload["file_ids"] = list(file_ids)
        if file_service_keys is not None:
            payload["file_service_keys"] = list(file_service_keys)
        if reason is not None:
            payload["reason"] = reason
        self._request("POST", "/add_files/delete_files", json=payload)

    def undelete_files(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
        file_service_keys: "Iterable[str] | None" = None,
    ) -> None:
        payload: dict[str, Any] = {}
        if hashes is not None:
            payload["hashes"] = list(hashes)
        if file_ids is not None:
            payload["file_ids"] = list(file_ids)
        if file_service_keys is not None:
            payload["file_service_keys"] = list(file_service_keys)
        self._request("POST", "/add_files/undelete_files", json=payload)

    def archive_files(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
    ) -> None:
        self._request(
            "POST", "/add_files/archive_files", json=_files_payload(hashes, file_ids)
        )

    def unarchive_files(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
    ) -> None:
        self._request(
            "POST", "/add_files/unarchive_files", json=_files_payload(hashes, file_ids)
        )

    def clear_file_deletion_record(
        self,
        file_ids: "Iterable[int] | None" = None,
        hashes: "Iterable[str] | None" = None,
    ) -> None:
        self._request(
            "POST",
            "/add_files/clear_file_deletion_record",
            json=_files_payload(hashes, file_ids),
        )

    def migrate_files(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
        file_service_keys: "Iterable[str] | None" = None,
        deleted_file_service_keys: "Iterable[str] | None" = None,
    ) -> None:
        """Copy files into additional local file services."""
        payload = _files_payload(hashes, file_ids)
        if file_service_keys is not None:
            payload["file_service_keys"] = list(file_service_keys)
        if deleted_file_service_keys is not None:
            payload["deleted_file_service_keys"] = list(deleted_file_service_keys)
        self._request("POST", "/add_files/migrate_files", json=payload)

    def generate_hashes(self, path: str) -> dict[str, Any]:
        """Hash a file on the client machine without importing it."""
        return self._request(
            "POST", "/add_files/generate_hashes", json={"path": str(path)}
        ).json()

    # -- tags ----------------------------------------------------------------

    def clean_tags(self, tags: "Iterable[str]") -> dict[str, Any]:
        """How Hydrus would normalize the given tags."""
        return self._request(
            "GET", "/add_tags/clean_tags", params={"tags": _jdump(tags)}
        ).json()

    def get_siblings_and_parents(self, tags: "Iterable[str]") -> dict[str, Any]:
        return self._request(
            "GET", "/add_tags/get_siblings_and_parents", params={"tags": _jdump(tags)}
        ).json()

    def add_tags(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
        service_keys_to_tags: "Mapping[str, Iterable[str]] | None" = None,
        service_keys_to_actions_to_tags: "Mapping[str, Mapping[str, Iterable[str]]] | None" = None,
    ) -> None:
        payload: dict[str, Any] = {}
        if hashes is not None:
            payload["hashes"] = list(hashes)
        if file_ids is not None:
            payload["file_ids"] = list(file_ids)
        if service_keys_to_tags is not None:
            payload["service_keys_to_tags"] = {
                k: list(v) for k, v in service_keys_to_tags.items()
            }
        if service_keys_to_actions_to_tags is not None:
            payload["service_keys_to_actions_to_tags"] = {
                k: {a: list(t) for a, t in v.items()}
                for k, v in service_keys_to_actions_to_tags.items()
            }
        self._request("POST", "/add_tags/add_tags", json=payload)

    def search_tags(
        self, search: str, tag_service_key: str | None = None
    ) -> dict[str, Any]:
        params: dict[str, Any] = {"search": search}
        if tag_service_key is not None:
            params["tag_service_key"] = tag_service_key
        return self._request("GET", "/add_tags/search_tags", params=params).json()

    # -- urls ----------------------------------------------------------------

    def get_url_info(self, url: str) -> dict[str, Any]:
        return self._request("GET", "/add_urls/get_url_info", params={"url": url}).json()

    def get_url_files(self, url: str) -> dict[str, Any]:
        return self._request("GET", "/add_urls/get_url_files", params={"url": url}).json()

    def add_url(
        self,
        url: str,
        destination_page_key: str | None = None,
        destination_page_name: str | None = None,
        show_destination_page: bool | None = None,
        service_keys_to_additional_tags: "Mapping[str, Iterable[str]] | None" = None,
    ) -> dict[str, Any]:
        payload: dict[str, Any] = {"url": url}
        if destination_page_key is not None:
            payload["destination_page_key"] = destination_page_key
        if destination_page_name is not None:
            payload["destination_page_name"] = destination_page_name
        if show_destination_page is not None:
            payload["show_destination_page"] = show_destination_page
        if service_keys_to_additional_tags is not None:
            payload["service_keys_to_additional_tags"] = {
                k: list(v) for k, v in service_keys_to_additional_tags.items()
            }
        return self._request("POST", "/add_urls/add_url", json=payload).json()

    def associate_url(
        self,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
        urls_to_add: "Iterable[str] | None" = None,
        urls_to_delete: "Iterable[str] | None" = None,
        normalise_urls: bool | None = None,
    ) -> None:
        if urls_to_add is None and urls_to_delete is None:
            raise ValueError("At least one of urls_to_add, urls_to_delete is required")
        payload = _files_payload(hashes, file_ids, normalise_urls=normalise_urls)
        if urls_to_add is not None:
            payload["urls_to_add"] = list(urls_to_add)
        if urls_to_delete is not None:
            payload["urls_to_delete"] = list(urls_to_delete)
        self._request("POST", "/add_urls/associate_url", json=payload)

    # -- notes ---------------------------------------------------------------

    def set_notes(
        self,
        notes: "Mapping[str, str]",
        hash_: str | None = None,
        file_id: int | None = None,
        merge_cleverly: bool | None = None,
        extend_existing_note_if_possible: bool | None = None,
        conflict_resolution: int | None = None,
    ) -> None:
        payload: dict[str, Any] = {"notes": dict(notes)}
        if hash_ is not None:
            payload["hash"] = hash_
        if file_id is not None:
            payload["file_id"] = file_id
        if merge_cleverly is not None:
            payload["merge_cleverly"] = merge_cleverly
        if extend_existing_note_if_possible is not None:
            payload["extend_existing_note_if_possible"] = extend_existing_note_if_possible
        if conflict_resolution is not None:
            payload["conflict_resolution"] = conflict_resolution
        self._request("POST", "/add_notes/set_notes", json=payload)

    def delete_notes(
        self,
        note_names: "Iterable[str]",
        hash_: str | None = None,
        file_id: int | None = None,
    ) -> None:
        payload: dict[str, Any] = {"note_names": list(note_names)}
        if hash_ is not None:
            payload["hash"] = hash_
        if file_id is not None:
            payload["file_id"] = file_id
        self._request("POST", "/add_notes/delete_notes", json=payload)

    # -- relationships (extended) ---------------------------------------------

    def get_file_relationships(
        self, hashes: "Iterable[str] | None" = None, file_ids: "Iterable[int] | None" = None
    ) -> dict[str, Any]:
        params: dict[str, Any] = {}
        if hashes is not None:
            params["hashes"] = _jdump(hashes)
        if file_ids is not None:
            params["file_ids"] = _jdump(file_ids)
        return self._request(
            "GET", "/manage_file_relationships/get_file_relationships", params=params
        ).json()

    def set_kings(
        self, hashes: "Iterable[str] | None" = None, file_ids: "Iterable[int] | None" = None
    ) -> None:
        payload: dict[str, Any] = {}
        if hashes is not None:
            payload["hashes"] = list(hashes)
        if file_ids is not None:
            payload["file_ids"] = list(file_ids)
        self._request("POST", "/manage_file_relationships/set_kings", json=payload)

    # -- ratings / times -------------------------------------------------------

    def set_rating(
        self,
        rating_service_key: str,
        rating: "bool | int | None",
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
    ) -> None:
        payload = _files_payload(hashes, file_ids)
        payload["rating_service_key"] = rating_service_key
        payload["rating"] = rating  # None explicitly clears the rating
        self._request("POST", "/edit_ratings/set_rating", json=payload)

    def set_time(
        self,
        timestamp_ms: int | None,
        timestamp_type: int,
        file_service_key: str | None = None,
        canvas_type: int | None = None,
        domain: str | None = None,
        hashes: "Iterable[str] | None" = None,
        file_ids: "Iterable[int] | None" = None,
    ) -> dict[str, Any]:
        payload = _files_payload(
            hashes,
            file_ids,
            file_service_key=file_service_key,
            canvas_type=None if canvas_type is None else int(canvas_type),
            domain=domain,
        )
        payload["timestamp_ms"] = timestamp_ms  # None deletes (where allowed)
        payload["timestamp_type"] = int(timestamp_type)
        return self._request("POST", "/edit_times/set_time", json=payload).json()

    # -- cookies / headers -----------------------------------------------------

    def get_cookies(self, domain: str) -> dict[str, Any]:
        return self._request(
            "GET", "/manage_cookies/get_cookies", params={"domain": domain}
        ).json()

    def set_cookies(self, cookies: "Iterable[Iterable[Any]]") -> None:
        self._request(
            "POST",
            "/manage_cookies/set_cookies",
            json={"cookies": [list(c) for c in cookies]},
        )

    def set_headers(
        self,
        headers: "Mapping[str, Mapping[str, Any]]",
        domain: str | None = None,
    ) -> None:
        payload: dict[str, Any] = {
            "headers": {k: dict(v) for k, v in headers.items()}
        }
        if domain is not None:
            payload["domain"] = domain
        self._request("POST", "/manage_headers/set_headers", json=payload)

    def set_user_agent(self, user_agent: str) -> None:
        import warnings

        warnings.warn(
            "set_user_agent() is deprecated, please use set_headers() instead",
            DeprecationWarning,
            stacklevel=2,
        )
        self._request(
            "POST", "/manage_headers/set_user_agent", json={"user-agent": user_agent}
        )

    # -- popups ------------------------------------------------------------------

    @staticmethod
    def _popup_payload(
        status_title=None,
        status_text_1=None,
        status_text_2=None,
        is_cancellable=None,
        is_pausable=None,
        attached_files_mergable=None,
        popup_gauge_1=None,
        popup_gauge_2=None,
        api_data=None,
        files_label=None,
        file_ids=None,
        hashes=None,
    ) -> dict[str, Any]:
        payload = _files_payload(
            hashes,
            file_ids,
            require=False,
            status_title=status_title,
            status_text_1=status_text_1,
            status_text_2=status_text_2,
            is_cancellable=is_cancellable,
            is_pausable=is_pausable,
            attached_files_mergable=attached_files_mergable,
            api_data=api_data,
            files_label=files_label,
        )
        if popup_gauge_1 is not None:
            payload["popup_gauge_1"] = list(popup_gauge_1)
        if popup_gauge_2 is not None:
            payload["popup_gauge_2"] = list(popup_gauge_2)
        return payload

    def get_popups(self, only_in_view: bool | None = None) -> dict[str, Any]:
        params: dict[str, Any] = {}
        if only_in_view is not None:
            params["only_in_view"] = _jdump(only_in_view)
        return self._request("GET", "/manage_popups/get_popups", params=params).json()

    def add_popup(self, **popup: Any) -> dict[str, Any]:
        """Create a popup; kwargs per _popup_payload (status_title,
        status_text_1/2, is_cancellable, popup_gauge_1/2, ...)."""
        return self._request(
            "POST", "/manage_popups/add_popup", json=self._popup_payload(**popup)
        ).json()

    def update_popup(self, job_status_key: str, **popup: Any) -> dict[str, Any]:
        payload = self._popup_payload(**popup)
        payload["job_status_key"] = job_status_key
        return self._request("POST", "/manage_popups/update_popup", json=payload).json()

    def _popup_action(
        self, path: str, job_status_key: str, seconds: int | None = None
    ) -> dict[str, Any]:
        payload: dict[str, Any] = {"job_status_key": job_status_key}
        if seconds is not None:
            payload["seconds"] = seconds
        return self._request("POST", path, json=payload).json()

    def dismiss_popup(self, job_status_key: str, seconds: int | None = None) -> dict[str, Any]:
        return self._popup_action("/manage_popups/dismiss_popup", job_status_key, seconds)

    def finish_popup(self, job_status_key: str, seconds: int | None = None) -> dict[str, Any]:
        return self._popup_action("/manage_popups/finish_popup", job_status_key, seconds)

    def cancel_popup(self, job_status_key: str, seconds: int | None = None) -> dict[str, Any]:
        return self._popup_action("/manage_popups/cancel_popup", job_status_key, seconds)

    def call_popup_user_callable(self, job_status_key: str) -> dict[str, Any]:
        return self._popup_action("/manage_popups/call_user_callable", job_status_key)

    # -- database ----------------------------------------------------------------

    def lock_database(self) -> None:
        self._request("POST", "/manage_database/lock_on")

    def unlock_database(self) -> None:
        self._request("POST", "/manage_database/lock_off")

    def get_client_options(self) -> dict[str, Any]:
        return self._request("GET", "/manage_database/get_client_options").json()

    def get_mr_bones(self) -> dict[str, Any]:
        """The client's fun aggregate statistics page."""
        return self._request("GET", "/manage_database/mr_bones").json()

    # -- pending (repository) content ---------------------------------------------

    def get_pending_counts(self) -> dict[str, Any]:
        return self._request("GET", "/manage_services/get_pending_counts").json()

    def commit_pending(self, service_key: str) -> None:
        self._request(
            "POST", "/manage_services/commit_pending", json={"service_key": service_key}
        )

    def forget_pending(self, service_key: str) -> None:
        self._request(
            "POST", "/manage_services/forget_pending", json={"service_key": service_key}
        )

    # -- session -------------------------------------------------------------

    def get_session_key(self) -> dict[str, Any]:
        return self._request("GET", "/session_key").json()

    # -- pages -------------------------------------------------------------

    def get_page_info(self, page_key: str, simple: bool | None = None) -> dict[str, Any]:
        params: dict[str, Any] = {"page_key": page_key}
        if simple is not None:
            params["simple"] = _jdump(simple)
        return self._request("GET", "/manage_pages/get_page_info", params=params).json()

    def get_pages(self) -> dict[str, Any]:
        return self._request("GET", "/manage_pages/get_pages").json()

    def add_files_to_page(
        self,
        page_key: str,
        file_ids: "Iterable[int] | None" = None,
        hashes: "Iterable[str] | None" = None,
    ) -> None:
        payload: dict[str, Any] = {"page_key": page_key}
        if file_ids is not None:
            payload["file_ids"] = list(file_ids)
        if hashes is not None:
            payload["hashes"] = list(hashes)
        self._request("POST", "/manage_pages/add_files", json=payload)

    def focus_page(self, page_key: str) -> None:
        self._request("POST", "/manage_pages/focus_page", json={"page_key": page_key})

    def refresh_page(self, page_key: str) -> None:
        self._request("POST", "/manage_pages/refresh_page", json={"page_key": page_key})


def verify_permissions(
    client: Client, permissions: "Iterable[int]", exact: bool = False
) -> bool:
    """True when the key's granted permissions cover (or exactly equal)
    ``permissions``."""
    granted = set(client.verify_access_key()["basic_permissions"])
    wanted = {int(p) for p in permissions}
    return granted == wanted if exact else granted.issuperset(wanted)
