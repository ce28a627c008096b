"""The cell's shapes, for the readers of roofline shares."""


def shape(run):
    m, f = run.cell.config["model"], run.cell.config["fit"]
    n, T = m["n_nodes"], m["n_time"]
    return n, T, 2 + 2 * m["latent_dim"], f["num_blocks"]
