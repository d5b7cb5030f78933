"""The m3msg wire: frames, the message bus and its socket transport."""
