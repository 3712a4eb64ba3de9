"""Frozen copies of the port's pure-Python host paths, the reference's host
side: the pileup and full-alignment extractors (``pileup_extractor.py``,
``fa_extractor.py``), the read-backed phaser, the decoder, routing
(``select.py``), merge and sort, and the BAM, FASTA, VCF and BGZF readers
and writers they and the traffic generator use.  Each is the port's module as it stood when the
benchmark was written, with imports pointed here and the native fast
paths taken out, so the reference runs the Python implementation only and
a later change to the program cannot move it.
"""
