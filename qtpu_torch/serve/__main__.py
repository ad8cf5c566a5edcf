"""``python -m qtpu_torch.serve`` — launch the HTTP server (see cli.py)."""
from qtpu_torch.serve.cli import main

raise SystemExit(main())
