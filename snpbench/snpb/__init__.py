"""The benchmark's own code: manifest, systems, reference, trace reading.

Nothing here imports the program except :mod:`.program`, which is the one
adapter between the benchmark's plain inputs and the port's ``explore``.
"""
