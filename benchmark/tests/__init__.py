"""The benchmark's own tests (not collected by the repository's tests/ run)."""
