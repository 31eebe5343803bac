from repro_torch.serve.telemetry.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
