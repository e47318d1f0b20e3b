"""Launch-side tools of the port (counterpart of `repro.launch`): the H100
roofline and the kernels' work counts (`roofline`), a step's work counted
from its parts (`cost`, the counterpart of `hlo_cost`), peak-intermediate
estimates (`memory`), the GP-LVM dry run at the paper's production scale
(`gp_dryrun`), and the LM side: device meshes (`mesh`), the train /
prefill / decode step functions (`steps`) and the `train` and `serve`
launchers. The reference's LM dry run (`launch/dryrun`) is not ported
yet."""
