"""``python -m repro_torch.scenarios`` — run the chaos scenario manifest."""
from repro_torch.scenarios.runner import main

if __name__ == "__main__":
    raise SystemExit(main())
