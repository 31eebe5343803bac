from repro_torch.core.autotune.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
