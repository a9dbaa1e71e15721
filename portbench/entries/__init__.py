"""Traffic entries: the code that drives one kind of step of the program.
A mix (``portbench/traffic/<mix>.json``) names its entry and holds its
parameters; each entry is a ``Driver`` found here by that name."""
