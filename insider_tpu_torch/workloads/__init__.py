"""The reference's per-dataset workloads (tests/*.R of the R package), one
runnable module each, with the JAX package's configurations
(workloads/*.py):

    python -m insider_tpu_torch.workloads.ageing [--data FILE]
        [--max-iter N] [--out NPZ] [--synthetic-cols M] [--device cpu]

ageing, gtex, simulation, prediXcan, brainspan, psyencode.  Without --data
each runs its configuration on a shape-matched synthetic matrix
(common.load_or_simulate).  Importing a module runs nothing; its main(argv)
runs the workload and returns the fitted Insider.
"""
