"""PsychENCODE workload (tests/psyencode.R:11-27): 3 confounders, K=3,
lambda=120, alpha=0.9, partition=0, global_tol=1e-10."""

from insider_tpu_torch.workloads.common import (load_or_simulate, parse_args,
                                                save_fitted)


def main(argv=None):
    import insider_tpu_torch as itt

    args = parse_args("psyencode", argv)
    data, conf = load_or_simulate(args, n_rows=800, level_counts=(30, 2, 10),
                                  latent_dim=3, confounder_cols=3)
    obj = itt.Insider(data, conf, global_tol=1e-10,
                      max_iter=args.max_iter or 50000, device=args.device)
    obj = obj.fit(3, lambda_=120, alpha=0.9, partition=0)
    save_fitted(obj, args.out or "insider_psyencode_R3_fitted_object.npz")
    return obj


if __name__ == "__main__":
    obj = main()
