"""Filter design and streaming FIR (counterpart: ``sondetpu/dsp``)."""
