"""The port's counterpart of ``repro.distributed``: the LM step builders
(``steps``), the collectives over a one-process mesh and their recorded
inventory (``collectives``, in place of the reference's HLO parsing in
``hlo``), the cost counts of one run on meta tensors (``cost``, in place
of ``hlo_cost``) and the roofline terms (``roofline``)."""
