"""Event I/O on the host: RAW decoding, packetized replay, stream filters
and the staging of frames into device memory."""
