"""The benchmark's own tests (python -m pytest benchmark/tests).

tiny.py's TINY names the tiny stand-in of each cell that its copy of the
manifest's metric lists may name.  The cells added to BENCHMARK.json
since get theirs here, on the package's import, so that every user of
tiny.make (the fixtures, and the fresh interpreters some tests start)
finds them: the SAM cache cell's stand-in is the one test_bench_sam.py
builds."""
from . import tiny

tiny.TINY.setdefault("sam-vit-h.cache-1024", "tiny-sam.c")
