"""``python -m sondetpu_torch.cli``: the port's command line."""

from sondetpu_torch.cli.main import main

if __name__ == "__main__":
    raise SystemExit(main())
