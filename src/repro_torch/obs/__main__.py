"""CLI: ``python -m repro_torch.obs --validate trace.jsonl`` (see export.main)."""
from .export import main

raise SystemExit(main())
