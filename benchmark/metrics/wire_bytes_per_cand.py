"""Bytes both engines handed to their host-to-device copies in the window
(their ``bytes_shipped``), per pileup candidate.  A count: it repeats
exactly for one seed."""


def read(rec):
    if not rec["candidates"]:
        return None
    return rec["wire_bytes"] / rec["candidates"]
