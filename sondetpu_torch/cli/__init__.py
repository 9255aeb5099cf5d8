"""Command-line interface and typed configuration (counterpart:
``sondetpu/cli``)."""
