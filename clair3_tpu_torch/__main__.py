from clair3_tpu_torch.cli import main

# the decode pool spawns workers that re-import __main__: run only as a script
if __name__ == "__main__":
    raise SystemExit(main())
