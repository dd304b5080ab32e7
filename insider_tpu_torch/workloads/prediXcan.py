"""prediXcan workload (tests/prediXcan.R, fully commented out in the
reference): disease x tissue z-score matrix, confounders parsed from sample
names via split_str, K=50.  Runnable here on synthetic data for
completeness."""

from insider_tpu_torch.workloads.common import (load_or_simulate, parse_args,
                                                save_fitted)


def main(argv=None):
    import insider_tpu_torch as itt

    args = parse_args("prediXcan", argv)
    data, conf = load_or_simulate(args, n_rows=300, level_counts=(12, 25),
                                  latent_dim=50, confounder_cols=2,
                                  log2=False)
    obj = itt.Insider(data, conf, global_tol=1e-9,
                      max_iter=args.max_iter or 1000, device=args.device)
    obj = obj.fit(50, lambda_=1.0, alpha=0.5, partition=1)
    save_fitted(obj, args.out or "insider_prediXcan_R50_fitted_object.npz")
    return obj


if __name__ == "__main__":
    obj = main()
