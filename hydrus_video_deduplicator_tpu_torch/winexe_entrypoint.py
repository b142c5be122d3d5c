"""Windows one-file executable entrypoint (CLI). Sets the windows-exe flag
so the console pauses before closing (reference entrypoint.py:280-285)."""

from hydrus_video_deduplicator_tpu_torch import config
from hydrus_video_deduplicator_tpu_torch.entrypoint import run_main

if __name__ == "__main__":
    config.set_windows_exe()
    run_main(gui=False)
