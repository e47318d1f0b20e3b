"""Launch-side tools of the port (counterpart of `repro.launch`): the H100
roofline and the kernels' work counts (`roofline`), a step's work counted
from its parts (`cost`, the counterpart of `hlo_cost`), peak-intermediate
estimates (`memory`) and the GP-LVM dry run at the paper's production scale
(`gp_dryrun`). The reference's LM-side launchers (`mesh`, `dryrun`,
`steps`, `train`, `serve`) come with the LM slice."""
