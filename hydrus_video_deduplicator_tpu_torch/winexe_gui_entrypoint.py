"""Windows one-file executable entrypoint (GUI)."""

from hydrus_video_deduplicator_tpu_torch import config
from hydrus_video_deduplicator_tpu_torch.entrypoint import run_main

if __name__ == "__main__":
    config.set_windows_exe()
    run_main(gui=True)
