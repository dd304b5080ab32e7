"""BrainSpan workload (tests/brainspan.R:12-29): 2 confounders, no
interaction, K=25, lambda=6, alpha=0.4, partition=0, global_tol=1e-10."""

from insider_tpu_torch.workloads.common import (load_or_simulate, parse_args,
                                                save_fitted)


def main(argv=None):
    import insider_tpu_torch as itt

    args = parse_args("brainspan", argv)
    data, conf = load_or_simulate(args, n_rows=500, level_counts=(16, 26),
                                  latent_dim=25, confounder_cols=2)
    obj = itt.Insider(data, conf, global_tol=1e-10,
                      max_iter=args.max_iter or 50000, device=args.device)
    obj = obj.fit(25, lambda_=6, alpha=0.4, partition=0)
    save_fitted(obj, args.out or "insider_brainspan_R25_fitted_object.npz")
    return obj


if __name__ == "__main__":
    obj = main()
