from hydrus_video_deduplicator_tpu_torch.entrypoint import run_main

if __name__ == "__main__":
    run_main()
