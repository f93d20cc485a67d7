# Convenience targets. CPU=1 prefixes force the CPU backend (tests default
# to CPU via tests/conftest.py regardless).

CPU_ENV = JAX_PLATFORM_NAME=cpu JAX_PLATFORMS=cpu

.PHONY: test native bench smoke chip-smoke datasets clean

# Synthetic exports of the three reference datasets at published scale
# (SURVEY.md §2.4 stats), in the reference's exact on-disk format. The
# real datasets do not exist on this machine; these exercise the loaders
# and the full-scale training path end-to-end.
datasets:
	python -c "from kgat_tpu.data import synthetic_dataset, save_dataset; \
	[save_dataset(synthetic_dataset(seed=0, n_users=u, n_items=i, \
	    n_entities=e, n_relations_kg=r, n_interactions=n, n_triples=t, \
	    name=nm), 'datasets') for nm, (u, i, e, r, n, t) in { \
	    'amazon-book': (70679, 24915, 88572, 39, 847733, 2557746), \
	    'last-fm': (23566, 48123, 58266, 9, 3034796, 464567), \
	    'yelp2018': (45919, 45538, 90961, 42, 1185068, 1853704)}.items()]"

# On a GPU: compile and check the SpMM kernel at yelp scale, train one
# epoch and serve from its checkpoint (exits nonzero without a GPU).
chip-smoke:
	python chip_smoke.py

test:
	python -m pytest tests/ -q

native:
	python -c "from kgat_tpu import native; print(native._SO)"

bench:
	python bench.py

smoke:
	$(CPU_ENV) python -m kgat_tpu.train --preset smoke-gcn --epochs 10 \
	    --eval-every 5 --run-name smoke

clean:
	rm -rf runs kgat_tpu/native/libkgat_native.so
	find . -name __pycache__ -type d -exec rm -rf {} +
