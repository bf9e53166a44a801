"""The plain reference the benchmark's check holds the program to: NumPy
only, nothing of the program (module docs of :mod:`.games`, :mod:`.net`
and :mod:`.search`)."""
