from repro_torch.core.costmodel.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
