"""Symbol timing, syncword correlation and bit packing (counterpart:
``sondetpu/sync``)."""
