"""The port's counterpart of ``repro.distributed``: the LM step builders
(``steps``). The reference's HLO, collective and roofline tools are not
ported (ROADMAP queue 1, item 17c)."""
