"""The benchmark's CPU tests; the card-only ones are marked `cuda`."""
