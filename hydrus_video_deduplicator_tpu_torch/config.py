"""Configuration: env vars, optional .env file, platform defaults.

Same env-var surface as the reference (upstream src/
hydrusvideodeduplicator/config.py): HYDRUS_API_KEY, HYDRUS_API_URL,
DEDUP_DATABASE_DIR, HYDRUS_QUERY, HYDRUS_LOCAL_FILE_SERVICE_KEYS,
FAILED_PAGE_NAME, REQUESTS_CA_BUNDLE, HVD_GUI. WSL detection points the
default API URL at the Windows host.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from platform import uname


class InvalidEnvironmentVariable(Exception):
    def __init__(self, msg: str):
        super().__init__(msg)
        print("Exiting due to invalid environment variable.")


def validate_json_array_env_var(env_var: str | None, err_msg: str) -> list | None:
    """Parse an env var that must be a JSON array; raise on anything else."""
    if env_var is None:
        return None
    try:
        parsed = json.loads(env_var)
        if not isinstance(parsed, list):
            raise InvalidEnvironmentVariable(f"ERROR: {err_msg}")
    except json.decoder.JSONDecodeError as exc:
        raise InvalidEnvironmentVariable(f"ERROR: {err_msg}") from exc
    return parsed


def _load_dotenv() -> None:
    """Load a .env file from the CWD if present (python-dotenv when
    installed; minimal parser otherwise)."""
    try:
        from dotenv import load_dotenv

        load_dotenv()
        return
    except ImportError:
        pass
    env_path = Path(".env")
    if not env_path.is_file():
        return
    for line in env_path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        os.environ.setdefault(key.strip(), value.strip().strip("'\""))


_load_dotenv()

HYDRUS_API_KEY = os.getenv("HYDRUS_API_KEY")


def in_wsl() -> bool:
    return "microsoft-standard" in uname().release


_DEFAULT_IP = "localhost"
_DEFAULT_PORT = "45869"
if in_wsl():
    # inside WSL the Hydrus client usually runs on the Windows host
    from socket import gethostname

    _DEFAULT_IP = f"{gethostname()}.local"

HYDRUS_API_URL = os.getenv("HYDRUS_API_URL", f"https://{_DEFAULT_IP}:{_DEFAULT_PORT}")


def _default_data_dir() -> str:
    try:
        from platformdirs import PlatformDirs

        return PlatformDirs("hydrusvideodeduplicator").user_data_dir
    except ImportError:
        return str(Path.home() / ".local" / "share" / "hydrusvideodeduplicator")


DEDUP_DATABASE_DIR = Path(os.getenv("DEDUP_DATABASE_DIR", _default_data_dir()))

FAILED_PAGE_NAME = os.getenv("FAILED_PAGE_NAME", None)
REQUESTS_CA_BUNDLE = os.getenv("REQUESTS_CA_BUNDLE")

HYDRUS_QUERY = validate_json_array_env_var(
    os.getenv("HYDRUS_QUERY"), err_msg="Ensure HYDRUS_QUERY is a JSON formatted array."
)
HYDRUS_LOCAL_FILE_SERVICE_KEYS = validate_json_array_env_var(
    os.getenv("HYDRUS_LOCAL_FILE_SERVICE_KEYS"),
    err_msg="Ensure HYDRUS_LOCAL_FILE_SERVICE_KEYS is a JSON formatted array",
)

HVD_GUI = os.getenv("HVD_GUI", False)

_IS_WINDOWS_EXE = False


def is_windows_exe() -> bool:
    return _IS_WINDOWS_EXE


def set_windows_exe() -> None:
    global _IS_WINDOWS_EXE
    _IS_WINDOWS_EXE = True
