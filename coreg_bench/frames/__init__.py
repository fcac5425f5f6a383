"""One module per frame a configuration names in ``frame``: how a pair is
rendered in it, which ``Alignment`` method aligns it, the plain reference
of its search and the program's route lines.  Found by name
(:func:`coreg_bench.discover.frame`); a new frame is a new module."""
